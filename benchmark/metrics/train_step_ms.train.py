"""Host time of one ``train_step`` call as the harness makes it, in ms: the
mean over the window (the benchmark times each call from its side)."""


def read(run):
    s = run.host.get("train_step_s")
    return 1e3 * sum(s) / len(s) if s else None
