"""The harness's own timer of CHAMELEON's metric tier
(``last_eval_phase_seconds["chameleon_metrics"]``) summed over the
window's eval hours, as a share of the window, in %."""


def read(run):
    s = run.host.get("metrics_tier_s")
    return 100.0 * s / run.window_s if s is not None and run.window_s else None
