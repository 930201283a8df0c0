"""One module per traffic driver, found by the ``driver`` a traffic mix
names.  Each has ``setup(run, device) -> state``, ``window(run, state,
device)``, ``reference_outputs(run, state, device, precision)``,
``system_outputs(run, state)``, ``as_system(run, state, ref_out)`` (a
reference's outputs in the system's form: the control), ``numbers(run,
state, sys_out, ref_out)`` and ``free(state)``."""
import importlib


def driver(name: str):
    return importlib.import_module(f"{__name__}.{name}")
