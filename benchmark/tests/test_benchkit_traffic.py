"""The traffic is the seed's alone, every seed does the same amount of
work, and the reference collates as the system does."""
import numpy as np

import tiny
from benchkit import traffic


def _hour(seed, hour=0, n=64):
    cfg = tiny.tiny_config("g1")
    mix = tiny.tiny_traffic("train_hours")
    r_corpus, r_hours = traffic.rngs(seed, 2)
    corpus = traffic.make_corpus(cfg, r_corpus, mix["item_zipf"])
    return corpus, traffic.hour_sessions(corpus, cfg, mix, r_hours, n, hour, 0)


def test_deterministic_in_the_seed():
    (c1, s1), (c2, s2) = _hour(2 ** 31 + 5), _hour(2 ** 31 + 5)
    assert np.array_equal(c1.ace, c2.ace)
    for a, b in ((s1.items, s2.items), (s1.ts, s2.ts), (s1.lengths, s2.lengths)):
        assert np.array_equal(a, b)
    _, s3 = _hour(2 ** 31 + 6)
    assert not np.array_equal(s1.items, s3.items)
    assert sorted(s1.lengths) == sorted(s3.lengths)  # the same work, in another order


def test_sessions_are_well_formed():
    corpus, s = _hour(9)
    live = np.arange(s.items.shape[1])[None] < s.lengths[:, None]
    assert ((s.items > 0) == live).all() and (s.items < corpus.num_items).all()
    both = live[:, 1:]
    assert (np.diff(s.ts, axis=1)[both] > 0).all()
    assert (s.ts[live] >= traffic.EPOCH).all() and (s.ts[live] < traffic.EPOCH + 2 * 3600).all()
    assert (np.diff(s.start) >= 0).all()


def test_collation_is_the_systems():
    """The reference's own collation gives what the system's does, on the
    keys the reference reads."""
    from benchkit import system
    from chameleon_recsys_tpu_torch.data.collate import collate_sessions
    from reference import nar

    cfg = tiny.tiny_config("g1")
    _, s = _hour(4, n=11)
    sessions, _ = system.schemas(cfg)
    dicts = traffic.serving_sessions(s)
    objs = system.to_sessions(dicts)
    model = nar.Model(cfg)
    for i in range(0, len(dicts), 8):
        mine = nar.train_batch(model, dicts[i:i + 8], 8)
        theirs = collate_sessions(objs[i:i + 8], sessions, 8, cfg["nar"]["max_session_length"])
        for k in mine:
            assert np.array_equal(mine[k], theirs[k]), k


def test_shift_moves_time_only():
    from benchkit.drivers.common import hour_objects, shift

    _, s = _hour(4, n=8)
    dicts = traffic.serving_sessions(s)
    objs = hour_objects(s)
    shift(objs, 3600)
    for o, d in zip(objs, dicts):
        assert o.timestamps == [t + 3600 for t in d["ts"]]
        assert o.session_start == d["start"] + 3600
        assert o.item_ids == d["items"]
