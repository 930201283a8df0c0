"""Dropout and the dense train path of the port against the JAX package.

Dropout masks cannot be drawn alike in the two frameworks, so the JAX
side's are read out: a Flax method interceptor records every
``nn.Dropout`` call's input and output in a jitted apply with the step's
dropout key, the mask is ``output != 0`` (or anything where the input is 0,
where the mask changes nothing), and the port's draws
(``ops/dropout.py::_draw_mask``) are replaced by those masks, call by call.
The JAX model drops out the stacked input/positive features, the dense
negatives' features, each UGRNN layer's output and the FC1 output, in that
order; the port draws the negatives' mask last.

The train step is ``tests/test_torch_train_step.py``'s: the same world,
perturbed weights, warm stream and sampler uniforms (derived from the JAX
``state.rng`` and injected).  At ``keep_prob`` 0.8 both models take the
dense path (the fused scorer off), with compaction (``scoring_rows``) and
over the whole grid.  Tolerances: float32 losses at rel 1e-5, every
gradient leaf at rtol 1e-5 / atol 1e-6 (the f32 noise of sums in another
order); bfloat16 losses at rel 5e-3 and each gradient leaf no further
from the float32 gradient (JAX, the same masks) than 1.5 times the JAX bf16
leaf is (normwise: the two frameworks round at other points, and each bf16
leaf lies 1-10% from the f32 one).  At ``keep_prob`` 1 the dense path (no pool in training)
against JAX's dense path at the same float32 tolerances.

``StackedUGRNN`` with dropout after each layer against the JAX stack at
the widths of ``tests/test_pallas_ugrnn.py`` (12 and 9 units), on the plain
recurrence and through ``UGRNNScan``'s CPU twin (the JAX side in Pallas
interpret mode): outputs at 1e-5, gradients at 1e-4, the tolerances of
``tests/test_torch_ugrnn.py``.  The primitive's keep rate within 3 sigma,
its bfloat16 division as JAX's, and ``nar_trainer_gcom --dropout_keep_prob
0.8 --platform cpu`` over a training hour and an eval hour.
"""
import csv

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.models.nar import NARAux as JaxNARAux
from chameleon_recsys_tpu.models.nar import l2_regularization as jax_l2_regularization
from chameleon_recsys_tpu.ops.rnn import StackedUGRNN as JaxStackedUGRNN
from chameleon_recsys_tpu.ops.sampling import (
    sample_negatives_pooled as jax_sample_negatives_pooled,
    sample_negatives_pooled_rows as jax_sample_negatives_pooled_rows,
)
from chameleon_recsys_tpu.train.steps import (
    _batch_all_clicks as jax_batch_all_clicks,
    build_nar_train,
)

from chameleon_recsys_tpu_torch.cli import make_pseudo_g1, nar_preprocess_gcom, nar_trainer_gcom
from chameleon_recsys_tpu_torch.convert import flax_from_tensors
from chameleon_recsys_tpu_torch.models.nar import NARAux
from chameleon_recsys_tpu_torch.ops import dropout as dropout_module
from chameleon_recsys_tpu_torch.ops.rnn import StackedUGRNN
from chameleon_recsys_tpu_torch.train.steps import train_step

from test_torch_eval_step import port_aux_consts, port_model, to_port_stream, warm_stream
from test_torch_train_step import (  # noqa: F401  (world: the shared fixture)
    G1_LEARNING_RATE,
    config,
    jax_compaction,
    jax_train_uniforms,
    leaves,
    port_setup,
    to_torch,
    world,
)

KEEP = 0.8
# the JAX model's dropout calls in order: stacked features, dense negatives,
# UGRNN layer 0, layer 1, FC1; the port draws the negatives' mask last
PORT_ORDER = (0, 2, 3, 4, 1)


def jax_dense_step(cfg, world, params, stream, batch, pooled=True):
    """The JAX train step's loss and gradients (``train_step_fn``'s
    ``loss_fn`` under ``jax.value_and_grad``, with ``state.rng``), and the
    (input, output) of every Dropout call of the same apply, in call order.
    ``pooled=False`` passes no pool, as the dense path at keep 1 needs."""
    model = build_nar_train(cfg, world["sess"], world["art"]).model
    key = jax.random.wrap_key_data(world["state"].rng, impl=cfg.rng_impl)
    _, step_rng = jax.random.split(key)
    rng_neg, rng_drop = jax.random.split(step_rng)
    all_clicked, _ = jax_batch_all_clicks(batch)
    sampler = dict(num_negatives=cfg.negative_samples,
                   buffer_sample_size=cfg.negative_sample_from_buffer,
                   mult=cfg.neg_sampling_multiplying_factor)
    extra = {}
    if cfg.train_valid_row_capacity is not None:
        rows_sel, row_mask, row_click, _ = jax_compaction(batch, cfg.train_valid_row_capacity)
        t = batch["item_clicked"].shape[1]
        pool, idx, ids = jax_sample_negatives_pooled_rows(
            rng_neg, all_clicked, stream.buffer_ids, rows_sel // t, row_click, **sampler)
        extra["scoring_rows"] = (rows_sel, row_mask)
    else:
        pool, idx, ids = jax_sample_negatives_pooled(
            rng_neg, all_clicked, stream.buffer_ids, **sampler)
        idx, ids = idx[:, :-1], ids[:, :-1]
    aux = JaxNARAux(world["ace"], world["metadata"], stream.recent_pop_norm,
                    stream.buffer_ids)

    def apply(p):
        return model.apply({"params": p}, batch, aux, ids, train=True, rank=False,
                           neg_pool=pool if pooled else None, neg_pool_idx=idx,
                           rngs={"dropout": rng_drop}, **extra)

    def loss_fn(p):
        calls = []
        out = dropout_calls(apply, p, calls=calls)
        reg = jax_l2_regularization(p, cfg.reg_weight_decay)
        return out.ce_loss + reg - out.nov_reg_loss, (out.ce_loss, reg, out.nov_reg_loss,
                                                      calls)

    # one program: the Dropout calls ride the gradient's forward as aux
    (loss, (ce, reg, nov, calls)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return dict(loss=loss, ce=ce, reg=reg, nov=nov, grads=grads, ids=ids, calls=calls,
                scoring_rows=extra.get("scoring_rows"))


def dropout_calls(fn, *args, calls=None):
    """(input, output) of every ``nn.Dropout`` call of ``fn(*args)``, in
    order; with ``calls`` (a list to fill), ``fn``'s own result."""
    recorded = [] if calls is None else calls

    def interceptor(next_fun, call_args, kwargs, context):
        out = next_fun(*call_args, **kwargs)
        if isinstance(context.module, jnn.Dropout) and context.method_name == "__call__":
            recorded.append((call_args[0], out))
        return out

    with jnn.intercept_methods(interceptor):
        result = fn(*args)
    return recorded if calls is None else result


def masks_of(calls):
    """The bool masks the Dropout calls drew (free where the input is 0)."""
    return [torch.from_numpy(np.array((out != 0) | (inp == 0))) for inp, out in calls]


@pytest.fixture
def inject(monkeypatch):
    """``inject(masks)``: the port's next draws are ``masks``, in order; the
    fixture checks that every mask was drawn, each at its own shape."""
    queue = []

    def draw(shape, keep, generator, device):
        assert keep == pytest.approx(KEEP)
        mask = queue.pop(0)
        assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
        return mask.to(device)

    monkeypatch.setattr(dropout_module, "_draw_mask", draw)
    yield queue.extend
    assert not queue, f"{len(queue)} masks not drawn"


def port_grads(model):
    return leaves(flax_from_tensors({n: p.grad for n, p in model.named_parameters()}))


def assert_grads_close(model, jax_grads):
    expected, got = leaves(jax_grads), port_grads(model)
    assert set(got) == set(expected)
    for path, want in expected.items():
        np.testing.assert_allclose(got[path], want, rtol=1e-5, atol=1e-6, err_msg=path)


CASES = {"rows": "capacity", "grid": None}


def dense_config(world, layout, dtype):
    return config(keep_prob=KEEP, train_valid_row_capacity=world["capacity"]
                  if CASES[layout] else None, novelty_reg_factor=0.1,
                  learning_rate=G1_LEARNING_RATE, use_pallas_scorer=True,
                  use_pallas_rnn=True, compute_dtype=dtype)


@pytest.fixture(scope="module")
def f32_rows(world):
    """The JAX dense step at keep 0.8 with compaction in float32: the rows
    case's reference, and the bf16 case's exact gradient (the same masks:
    the draws depend on the key and the shapes only)."""
    params = jax.tree_util.tree_map(jnp.asarray, world["params"])
    cfg = dense_config(world, "rows", "float32")
    return jax_dense_step(cfg, world, params, warm_stream(world, cfg, 2), world["batches"][0])


@pytest.mark.parametrize("layout,dtype", [("rows", "float32"), ("grid", "float32"),
                                          ("rows", "bfloat16")])
def test_dense_dropout_train_step_matches_jax(world, f32_rows, inject, layout, dtype):
    capacity = world["capacity"] if CASES[layout] else None
    cfg = dense_config(world, layout, dtype)
    batch = world["batches"][0]
    params = jax.tree_util.tree_map(jnp.asarray, world["params"])
    jax_out = (f32_rows if (layout, dtype) == ("rows", "float32") else
               jax_dense_step(cfg, world, params, warm_stream(world, cfg, 2), batch))
    masks = masks_of(jax_out["calls"])
    assert len(masks) == 5 and all(m.dtype == torch.bool for m in masks)
    dropped = float(torch.cat([(~m).float().reshape(-1) for m in masks]).mean())
    assert 0.1 < dropped < 0.3, dropped  # the JAX side really dropped

    jax_metrics = {"loss": jax_out["loss"], "ce_loss": jax_out["ce"],
                   "reg_loss": jax_out["reg"]}
    if (layout, dtype) == ("rows", "float32"):
        programs = build_nar_train(cfg, world["sess"], world["art"])
        jax_state = world["state"]._replace(
            params=params, opt_state=programs.optimizer.init(params),
            stream=warm_stream(world, cfg, 2))
        _, step_metrics = jax.jit(programs.train_step_fn)(jax_state, batch, world["ace"],
                                                          world["metadata"])
        # the replica of loss_fn is train_step_fn's
        assert float(step_metrics["loss"]) == pytest.approx(float(jax_out["loss"]),
                                                            rel=1e-6)

    state, ace, metadata = port_setup(world, cfg)
    rows = min(capacity, cfg.batch_size * cfg.max_inputs_length) if capacity else None
    uniforms, _ = jax_train_uniforms(cfg, world["state"].rng, rows, cfg.batch_size,
                                     cfg.max_session_length,
                                     cfg.recent_clicks_buffer_max_size)
    inject([masks[i] for i in PORT_ORDER])
    state, metrics = train_step(state, to_torch(batch), ace, metadata, uniforms=uniforms)
    rel = 1e-5 if dtype == "float32" else 5e-3
    for key in ("loss", "ce_loss", "reg_loss"):
        assert float(metrics[key]) == pytest.approx(float(jax_metrics[key]), rel=rel), key
    if dtype == "float32":
        assert_grads_close(state.model, jax_out["grads"])
        return
    # bf16: the port's gradient no further from the float32 one (JAX, the
    # same masks) than 1.5 times JAX's bf16 gradient is
    expected, got = leaves(jax_out["grads"]), port_grads(state.model)
    exact = leaves(f32_rows["grads"])
    assert set(got) == set(expected)
    for path, want in expected.items():
        jax_err = np.linalg.norm(want - exact[path])
        assert np.linalg.norm(got[path] - exact[path]) <= 1.5 * jax_err + 1e-6, path


@pytest.mark.parametrize("layout", list(CASES))
def test_dense_path_at_keep_1_matches_jax(world, layout):
    """Training without a pool takes the dense path in both packages: the
    forward's loss terms and every gradient."""
    capacity = world["capacity"] if CASES[layout] else None
    cfg = config(train_valid_row_capacity=capacity, novelty_reg_factor=0.1,
                 use_pallas_scorer=True, use_pallas_rnn=True)
    batch = world["batches"][1]
    params = jax.tree_util.tree_map(jnp.asarray, world["params"])
    stream = warm_stream(world, cfg, 2)
    jax_out = jax_dense_step(cfg, world, params, stream, batch, pooled=False)
    model = port_model(world, cfg)
    ace, metadata = port_aux_consts(world)
    port_stream = to_port_stream(stream)
    aux = NARAux(ace, metadata, port_stream.recent_pop_norm, port_stream.buffer_ids)
    rows = jax_out["scoring_rows"]
    out = model(to_torch(batch), aux, torch.from_numpy(np.array(jax_out["ids"])),
                train=True, scoring_rows=None if rows is None else (
                    torch.from_numpy(np.array(rows[0])).long(),
                    torch.from_numpy(np.array(rows[1]))))
    loss = out.ce_loss - out.nov_reg_loss
    for got, want in ((out.ce_loss, jax_out["ce"]), (out.nov_reg_loss, jax_out["nov"])):
        assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert float(out.nov_reg_loss) > 0
    from chameleon_recsys_tpu_torch.train.loss import l2_regularization

    (loss + l2_regularization(model, cfg.reg_weight_decay)).backward()
    for param in model.parameters():  # untouched leaves: JAX's zeros
        if param.grad is None:
            param.grad = torch.zeros_like(param)
    assert_grads_close(model, jax_out["grads"])


@pytest.mark.parametrize("units,kernel", [(12, False), (12, True), (9, True)],
                         ids=["12-plain", "12-kernel", "9-kernel"])
def test_stacked_ugrnn_dropout_matches_jax(inject, units, kernel):
    rng = np.random.RandomState(units)
    b, t, d = 4, 6, 10
    x = rng.randn(b, t, d).astype(np.float32)
    lengths = np.array([t, 3, 0, 5])
    mask = np.arange(t)[None, :] < lengths[:, None]
    jax_rnn = JaxStackedUGRNN(units, 2, keep_prob=KEEP, use_pallas=kernel)
    key = jax.random.PRNGKey(3)
    params = jax_rnn.init({"params": key}, jnp.asarray(x), jnp.asarray(mask))["params"]

    def f(p, xs):
        return jax_rnn.apply({"params": p}, xs, jnp.asarray(mask), deterministic=False,
                             rngs={"dropout": key})

    g_out = rng.randn(b, t, units).astype(np.float32)

    @jax.jit
    def reference(p, xs):
        want, vjp = jax.vjp(f, p, xs)
        return want, vjp(jnp.asarray(g_out)), dropout_calls(f, p, xs)

    want, (g_params, g_x), calls = reference(params, jnp.asarray(x))
    assert len(calls) == 2

    port = StackedUGRNN(d, units, 2, use_kernel=kernel, keep_prob=KEEP)
    with torch.no_grad():
        for i, layer in enumerate(port.layers):
            p = params[f"layer_{i}"]
            layer.input_proj.weight.copy_(torch.from_numpy(np.array(p["input_proj"]["kernel"]).T))
            layer.input_proj.bias.copy_(torch.from_numpy(np.array(p["input_proj"]["bias"])))
            layer.recurrent_kernel.copy_(torch.from_numpy(np.array(p["recurrent_kernel"])))
    xt = torch.from_numpy(x).requires_grad_()
    inject(masks_of(calls))
    got = port(xt, torch.from_numpy(mask), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    got.backward(torch.from_numpy(g_out))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-4)
    for i, layer in enumerate(port.layers):
        p = g_params[f"layer_{i}"]
        for got_g, want_g in ((layer.input_proj.weight.grad.T, p["input_proj"]["kernel"]),
                              (layer.input_proj.bias.grad, p["input_proj"]["bias"]),
                              (layer.recurrent_kernel.grad, p["recurrent_kernel"])):
            np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-4)
    # outside training the stack draws nothing and equals the JAX eval stack
    eval_out = jax.jit(jax_rnn.apply)({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        np.testing.assert_allclose(port(xt, torch.from_numpy(mask)).numpy(),
                                   np.asarray(eval_out), atol=1e-5)


def test_mask_keep_rate_within_three_sigma():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(400, 1000)
    out = dropout_module.dropout(x, KEEP, g)
    kept = (out != 0).float().mean().item()
    sigma = (KEEP * (1 - KEEP) / x.numel()) ** 0.5
    assert abs(kept - KEEP) < 3 * sigma, kept
    # kept elements are divided by keep_prob, the rest zero
    assert torch.unique(out).tolist() == [0.0, pytest.approx(1 / KEEP)]
    # the generator decides the draw
    again = dropout_module.dropout(x, KEEP, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert dropout_module.dropout(x, 1.0, g) is x


def test_bf16_division_is_jax_weak_typed_one():
    """JAX divides a bf16 array by the weak-typed keep rounded to bf16 (in
    bf16, x / 0.8 differs from x / bf16(0.8) in about one element of seven)."""
    values = np.random.RandomState(0).randn(4096).astype(np.float32)
    jx = jnp.asarray(values).astype(jnp.bfloat16)
    want = np.asarray(jnn.Dropout(rate=1.0 - KEEP).apply(
        {}, jx, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)}
    ).astype(jnp.float32))
    mask = torch.from_numpy(want != 0)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).bfloat16()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(dropout_module, "_draw_mask", lambda *a: mask)
        got = dropout_module.dropout(tx, KEEP).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_nar_trainer_gcom_trains_with_dropout(tmp_path):
    """``--dropout_keep_prob 0.8`` on the CPU: a training hour with dropout
    on the dense path, then an eval hour (pooled, no dropout)."""
    make_pseudo_g1.main(["--output_dir", str(tmp_path / "bundle"), "--hours", "3",
                         "--num_articles", "200", "--mean_sessions_per_hour", "80",
                         "--ace_dim", "8", "--seed", "3"])
    nar_preprocess_gcom.main([
        "--input_clicks_csv_path_regex", str(tmp_path / "bundle" / "clicks" / "clicks_hour_*.csv"),
        "--output_sessions_tfrecords_path",
        str(tmp_path / "sessions" / "sessions_hour_*.tfrecord.gz")])
    nar_trainer_gcom.main([
        "--train_set_path_regex", str(tmp_path / "sessions" / "sessions_hour_*.tfrecord.gz"),
        "--acr_module_articles_metadata_csv_path",
        str(tmp_path / "bundle" / "articles_metadata.csv"),
        "--acr_module_articles_content_embeddings_pickle_path",
        str(tmp_path / "bundle" / "articles_embeddings.pickle"),
        "--model_dir", str(tmp_path / "model"), "--train_files_from", "1",
        "--training_hours_for_each_eval", "1", "--batch_size", "8",
        "--truncate_session_length", "6", "--CAR_embedding_size", "16",
        "--rnn_units", "12", "--train_total_negative_samples", "4",
        "--train_negative_samples_from_buffer", "20", "--eval_total_negative_samples", "4",
        "--eval_negative_samples_from_buffer", "20", "--eval_metrics_top_n", "3",
        "--recent_clicks_buffer_max_size", "128", "--recent_clicks_for_normalization", "64",
        "--compute_dtype", "float32", "--dropout_keep_prob", "0.8",
        "--disable_eval_benchmarks", "--save_scalars", "--platform", "cpu"])
    with open(tmp_path / "model" / "eval_stats_benchmarks.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    assert np.isfinite(float(rows[0]["mrr_at_n"]))
    assert rows[0]["hitrate_at_n"] == rows[0]["hitrate_at_n_chameleon"]
    scalars = (tmp_path / "model" / "train_scalars.jsonl").read_text().splitlines()
    assert scalars and all('"loss"' in line for line in scalars)
