"""The JAX package's G1 trainer CLI over a mesh of virtual CPU devices, in
a process of its own (the test process's JAX has eight devices, and the
CLI's mesh takes them all), for ``tests/test_torch_cli_g1.py``.

Its harness's stream is warmed with one session file's clicks, as that
test's ``WarmJaxHarness`` does; what the run starts from (the config, the
params, the raw key and the stream) is pickled for the port's run.

Usage: python tests/_jax_cli_mesh.py <devices> <warm file> <out.pkl> <CLI flags...>
"""
import os
import pickle
import sys
from pathlib import Path


def main():
    devices, warm_file, out_path, argv = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                          sys.argv[4:])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    os.environ["CHAMELEON_JAX_CACHE"] = ""  # no compile cache outside the run
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import numpy as np

    from chameleon_recsys_tpu.cli import nar_trainer_gcom as jax_trainer
    from chameleon_recsys_tpu.data.collate import collate_sessions
    from chameleon_recsys_tpu.data.sessions import read_sessions_tfrecord
    from chameleon_recsys_tpu.state.stream_state import update_stream_state
    from chameleon_recsys_tpu.train.steps import _batch_all_clicks

    captured = {}

    class WarmJaxHarness(jax_trainer.TemporalHarness):
        def init_from_batch(self, example_batch):
            super().init_from_batch(example_batch)
            cfg, stream = self.cfg, self.state.stream
            sessions = read_sessions_tfrecord(warm_file, self.session_schema)
            for i in range(0, len(sessions), cfg.batch_size):
                batch = collate_sessions(sessions[i: i + cfg.batch_size],
                                         self.session_schema, cfg.batch_size,
                                         cfg.max_session_length)
                stream = update_stream_state(stream, *_batch_all_clicks(batch), cfg)
            self.state = jax.device_put(self.state._replace(stream=stream),
                                        self._sharded.state_sharding)
            captured.update(
                cfg=cfg, rng=np.asarray(self.state.rng).copy(),
                params=jax.tree_util.tree_map(np.asarray, self.state.params),
                stream={k: np.asarray(v).copy() for k, v in stream._asdict().items()})

    jax_trainer.TemporalHarness = WarmJaxHarness
    jax_trainer.main(argv)
    with open(out_path, "wb") as f:
        pickle.dump(captured, f)


if __name__ == "__main__":
    main()
