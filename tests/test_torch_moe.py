"""Port parity for the MoE family (`repro_torch.models.moe`, olmoe-1b-7b
and phi3.5-moe-42b-a6.6b) against the JAX package on the same numpy
weights and inputs.

* The FFN: `moe_ffn` routed (capacity factor 1.25), dropless (-1) and at
  capacity 0.25, and the oracle `moe_ffn_dense`, at the reduced olmoe's
  widths (d 256, 4 experts, top-2, expert width 128): outputs atol 1e-5,
  the aux loss rtol 1e-6.  The inputs' top-k margins are asserted well
  above f32 rounding, so both packages pick the same experts.
* The drops, token for token: the reference's own routing (gates and ids
  from jax) fed into the port's `dispatch` gives the reference's output
  (atol 1e-5) and the same tokens dropped whole; a router that sends
  every token to the same two experts measures the reference's capacity
  arithmetic from its output, for four capacity factors.
* The model: the reduced olmoe and phi3.5-moe loss and gradients (rtol
  1e-4 / atol 1e-5, as ``tests/test_torch_dense_family.py``), routed, the
  router margins of every block asserted; a W = 2 dc_s3gd trajectory of
  the reduced olmoe (tolerances of ``tests/test_torch_ssm_train.py``).
* Serving: greedy tokens equal the reference's through both schedulers
  (the prefill's drops depend on which prompts share a batch, so the
  admission groups must be the reference's); paged == dense bitwise
  within the port; ``chunkable`` refuses routed MoE and accepts
  ``moe_dense``, as the reference's gate does.
* Weights cross both ways: the (E, ...) expert leaves and the f32 router
  through `repro_torch.interop` and the ``.npz`` checkpoint format.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as j_restore
from repro.checkpoint import save_pytree as j_save
from repro.configs import get_config, reduced
from repro.core import registry as jreg
from repro.core.types import DCS3GDConfig as JConfig
from repro.data import SyntheticLMDataset as JData
from repro.data import worker_batches as j_worker_batches
from repro.models import moe as j_moe
from repro.models.cache import PagedLayout as JPagedLayout
from repro.models.transformer import Model as JModel
from repro.models.transformer import stage_plan as j_stage_plan
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch import tree as T
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import registry as treg
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.data.pipeline import SyntheticLMDataset as TData
from repro_torch.data.pipeline import worker_batches as t_worker_batches
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.models.cache import DenseLayout, PagedLayout
from repro_torch.models.transformer import Model, stage_plan
from repro_torch.serve import Request, Scheduler
from torch_threads import one_torch_thread  # noqa: F401

OLMOE, PHI = "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"
ARCHS = pytest.mark.parametrize("arch", [OLMOE, PHI])
RTOL, ATOL = 1e-4, 1e-5
MARGIN = 1e-5        # top-k margin asserted: f32 rounding is ~1e-7
V = 512


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jm = JModel(reduced(get_config(arch)), remat=False)
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _models(arch, moe_dense=False):
    jm = JModel(reduced(get_config(arch)), remat=False, moe_dense=moe_dense,
                q_chunk=16, kv_chunk=16, scan_chunk=16, loss_chunk=16)
    # the reference's knobs: no remat (a recompute would route again),
    # 16-wide attention blocks
    tm = Model(t_reduced(t_get_config(arch)), remat=False, q_chunk=16,
               kv_chunk=16, scan_chunk=16, loss_chunk=16,
               moe_dense=moe_dense)
    return jm, tm


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def _margins(probs: np.ndarray, k: int):
    """The smallest gap of any token between its k-th and (k+1)-th and
    between its first and second probability."""
    p = -np.sort(-probs.reshape(-1, probs.shape[-1]), axis=-1)
    return float(min((p[:, k - 1] - p[:, k]).min(),
                     (p[:, 0] - p[:, 1]).min()))


@pytest.fixture
def recorded_margins(monkeypatch):
    """Every `route` call of the port records its tokens' top-k margin."""
    seen = []
    route = moe.route

    def recording(params, xt, cfg):
        out = route(params, xt, cfg)
        seen.append(_margins(out[0].detach().numpy(), cfg.top_k))
        return out
    monkeypatch.setattr(moe, "route", recording)
    return seen


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@ARCHS
def test_configs_and_stage_plan_match_reference(arch):
    for cfg, jcfg in ((t_get_config(arch), get_config(arch)),
                      (t_reduced(t_get_config(arch)),
                       reduced(get_config(arch)))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert [(s.kinds, s.repeats) for s in stage_plan(cfg)] == \
            [(s.kinds, s.repeats) for s in j_stage_plan(jcfg)]
    assert t_reduced(t_get_config(arch)).moe.n_experts == 4


@ARCHS
def test_full_param_count_matches_reference(arch, monkeypatch):
    """The published config's tree, shapes and count, without allocating
    it: the port's init runs on meta tensors."""
    shapes = jax.eval_shape(JModel(get_config(arch)).init,
                            jax.random.PRNGKey(0))
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(shapes)]

    class MetaGen:
        device = torch.device("meta")
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None: torch.empty(shape, device="meta"))
    params = Model(t_get_config(arch)).init(MetaGen())
    got = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for x in T.leaves(params)]
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got) == {
        OLMOE: 6_919_624_704, PHI: 41_874_100_224}[arch]


def test_params_have_the_reference_tree():
    got = Model(t_reduced(t_get_config(OLMOE))).init(
        torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_flatten_with_path(_weights(OLMOE))[0]
    assert len(T.leaves(got)) == len(want)
    names = [jax.tree_util.keystr(p) for p, _ in want]
    assert "['stage0']['b0']['moe']['router']" in names
    for (path, a), t in zip(want, T.leaves(got)):
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).replace("torch.", "") == str(a.dtype), path


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------


def _ffn_inputs(seed=0, T_=32):
    cfg = reduced(get_config(OLMOE))
    p = j_moe.init_moe(jax.random.PRNGKey(seed), cfg.d_model, cfg.moe, True,
                       jnp.float32)
    p = jax.tree.map(np.asarray, p)
    x = np.random.default_rng(seed).standard_normal(
        (2, T_ // 2, cfg.d_model)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("mode", ["routed", "dropless", "capacity_0.25",
                                  "dense"])
def test_moe_ffn_matches_reference(mode):
    jcfg, p, x = _ffn_inputs()
    tcfg = t_reduced(t_get_config(OLMOE))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ p["router"], -1))
    assert _margins(probs, jcfg.moe.top_k) > MARGIN
    tp, tx = params_from_numpy(p, device="cpu"), torch.from_numpy(x)
    if mode == "dense":
        want = j_moe.moe_ffn_dense(p, jnp.asarray(x), jcfg.moe, "silu")
        got = moe.moe_ffn_dense(tp, tx, tcfg.moe, "silu")
    else:
        cf = {"routed": 1.25, "dropless": -1.0, "capacity_0.25": 0.25}[mode]
        want = j_moe.moe_ffn(p, jnp.asarray(x), jcfg.moe, "silu",
                             capacity_factor=cf)
        got = moe.moe_ffn(tp, tx, tcfg.moe, "silu", capacity_factor=cf)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].item(), float(want[1]), rtol=1e-6)
    if mode == "capacity_0.25":       # tokens were dropped whole
        dropped = np.abs(np.asarray(want[0])).reshape(-1, x.shape[-1]) \
            .max(-1) == 0
        assert dropped.sum() > 0


def test_dropless_moe_ffn_is_the_oracle():
    """Within the port: with no drops the routed FFN is the oracle's
    function (atol 1e-5; the sums run in another order)."""
    _, p, x = _ffn_inputs(1)
    tcfg = t_reduced(t_get_config(OLMOE))
    tp, tx = params_from_numpy(p, device="cpu"), torch.from_numpy(x)
    a, aux_a = moe.moe_ffn(tp, tx, tcfg.moe, "silu", capacity_factor=-1.0)
    b, aux_b = moe.moe_ffn_dense(tp, tx, tcfg.moe, "silu")
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert aux_a.item() == aux_b.item()


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_drops_match_reference_token_for_token(cf):
    """The reference's routing fed into the port's dispatch: its output
    (atol 1e-5), and exactly its tokens dropped whole."""
    jcfg, p, x = _ffn_inputs(2)
    tcfg = t_reduced(t_get_config(OLMOE))
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt @ p["router"], -1)
    gates, idx = jax.lax.top_k(probs, jcfg.moe.top_k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    want = np.asarray(j_moe.moe_ffn(p, jnp.asarray(x), jcfg.moe, "silu",
                                    capacity_factor=cf)[0]).reshape(xt.shape)
    got = moe.dispatch(params_from_numpy(p, device="cpu"),
                       torch.from_numpy(np.array(xt)),
                       torch.from_numpy(np.array(gates)),
                       torch.from_numpy(np.array(idx)).long(), tcfg.moe,
                       "silu", cf).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.abs(got).max(-1) == 0,
                                  np.abs(want).max(-1) == 0)


@pytest.mark.parametrize("cf", [1.25, 0.3, 0.25, 0.1])
def test_capacity_is_the_reference_arithmetic(cf):
    """A router that sends all 16 tokens to experts 0 and 1: each expert
    keeps its first ``cap`` tokens, so the reference's output has exactly
    ``cap`` live rows; `capacity` gives the same number (10, 2, 2 and 1:
    the last is ``int(0.8) or 1``).  The inputs are all positive, so the
    router's choice does not depend on them; its logits stay near 4, where
    their rounding is small.  Outputs atol 1e-5."""
    jcfg, p, x = _ffn_inputs(3, T_=16)
    p = dict(p, router=np.zeros_like(p["router"]))
    x = np.abs(x)
    p["router"][:, 0], p["router"][:, 1] = 0.02, 0.019
    out = np.asarray(j_moe.moe_ffn(p, jnp.asarray(x), jcfg.moe, "silu",
                                   capacity_factor=cf)[0])
    live = int((np.abs(out).reshape(16, -1).max(-1) > 0).sum())
    tcfg = t_reduced(t_get_config(OLMOE))
    assert moe.capacity(16, tcfg.moe, cf) == live
    got = moe.moe_ffn(params_from_numpy(p, device="cpu"),
                      torch.from_numpy(x), tcfg.moe, "silu",
                      capacity_factor=cf)[0]
    np.testing.assert_allclose(got.numpy(), out, atol=1e-5, rtol=0)
    assert moe.capacity(16, tcfg.moe, -1.0) == 16


def test_top_k_keeps_the_lower_expert_first_among_ties():
    """jax's ``lax.top_k`` orders equal probabilities by expert id; the
    port's route does too (a stable descending sort)."""
    tcfg = t_reduced(t_get_config(OLMOE))
    params = {"router": torch.zeros((3, 4))}
    _, gates, idx = moe.route(params, torch.ones((5, 3)), tcfg.moe)
    j_gates, j_idx = jax.lax.top_k(jnp.full((5, 4), 0.25), 2)
    assert idx.tolist() == np.asarray(j_idx).tolist() == [[0, 1]] * 5
    assert gates.tolist() == [[0.5, 0.5]] * 5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@ARCHS
def test_loss_and_grads_match_jax(arch, recorded_margins):
    jm, tm = _models(arch)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, V, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, V, (2, 24)).astype(np.int32)}
    batch["labels"][:, -2:] = -1
    j_loss, j_grads = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, _weights(arch)),
        jax.tree.map(jnp.asarray, batch))
    tp = params_from_numpy(_weights(arch), device="cpu")
    leaves = T.leaves(tp)
    for x in leaves:
        x.requires_grad_()
    t_loss = tm.loss(tp, params_from_numpy(batch, device="cpu"))
    t_grads = torch.autograd.grad(t_loss, leaves)
    assert len(recorded_margins) == 2 and min(recorded_margins) > MARGIN
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=RTOL,
                               atol=ATOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(j_grads)[0]]
    for path, a, b in zip(paths, t_grads, jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def test_aux_loss_is_summed_into_the_loss(monkeypatch):
    """The loss is the cross-entropy plus each MoE block's aux loss."""
    _, tm = _models(OLMOE)
    tp = params_from_numpy(_weights(OLMOE), device="cpu")
    toks = torch.from_numpy(_tokens((2, 16), 1)).long()
    batch = {"tokens": toks, "labels": toks}
    with_aux = tm.loss(tp, batch)
    auxes = []
    ffn = moe.moe_ffn

    def no_aux(*a, **kw):
        out, aux = ffn(*a, **kw)
        auxes.append(aux)
        return out, torch.zeros_like(aux)
    monkeypatch.setattr(moe, "moe_ffn", no_aux)
    ce = tm.loss(tp, batch)
    assert len(auxes) == 2 and all(a.item() > 0 for a in auxes)
    np.testing.assert_allclose(with_aux.item() - ce.item(),
                               sum(a.item() for a in auxes), rtol=1e-5)


W, STEPS, BPW, SEQ = 2, 3, 2, 16
HP = dict(learning_rate=0.05, momentum=0.9, lambda0=0.2, weight_decay=1e-3,
          total_steps=1)
METRICS = ("loss", "lambda", "distance_norm", "delta_norm")


def test_dc_s3gd_trajectory_matches_jax(recorded_margins):
    """Three routed dc_s3gd steps of the reduced olmoe at W = 2 through the
    fused bucketed tail (the reference's Pallas kernels in interpret mode,
    A1/A2's plain versions here): every leaf's update, m and delta_prev
    within 1e-4 of the leaf's largest reference magnitude (or one ulp of
    its largest weight), the metrics rtol 1e-5."""
    jm, tm = _models(OLMOE)
    cfg = reduced(get_config(OLMOE))
    j_alg = jreg.make("dc_s3gd", JConfig(**HP), n_workers=W, buckets=2,
                      use_kernels=True)
    t_alg = treg.make("dc_s3gd", TConfig(**HP), n_workers=W, buckets=2,
                      use_kernels=True)
    js = j_alg.init(jax.tree.map(jnp.asarray, _weights(OLMOE)))
    ts = t_alg.init(params_from_numpy(_weights(OLMOE), device="cpu"))
    step = jax.jit(functools.partial(j_alg.step, loss_fn=jm.loss))
    jd, td = JData(cfg.vocab_size, SEQ, seed=0), TData(cfg.vocab_size, SEQ,
                                                        seed=0)
    for t in range(STEPS):
        js, jmet = step(js, j_worker_batches(jd, t, W, BPW))
        ts, tmet = t_alg.step(ts, t_worker_batches(td, t, W, BPW,
                                                   device="cpu"),
                              loss_fn=tm.loss)
        for k in METRICS:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert min(recorded_margins) > MARGIN
    base = jax.tree.leaves(_weights(OLMOE))
    for what, ours, theirs, sub in (
            ("params", ts.params, js.params, base),
            ("m", ts.opt["m"], js.opt["m"], None),
            ("delta_prev", ts.comm["delta_prev"], js.comm["delta_prev"],
             None)):
        for i, (x, y) in enumerate(zip(T.leaves(ours),
                                       jax.tree.leaves(theirs))):
            x, y = x.numpy(), np.asarray(y)
            ulp = 0.0
            if sub is not None:
                x, y = x - sub[i], y - sub[i]
                ulp = float(np.spacing(np.abs(sub[i]).max()))
            np.testing.assert_allclose(
                x, y, rtol=0, atol=max(1e-4 * float(np.abs(y).max()), ulp),
                err_msg=f"{what} {i}")


def test_train_launcher_builds_the_oracle_at_the_reduced_size():
    """``--reduced`` trains through ``moe_dense``, as the reference's
    launcher builds it; two steps give a finite loss."""
    args = train.build_argparser().parse_args([
        "--arch", OLMOE, "--reduced", "--workers", "2", "--batch-per-worker",
        "1", "--seq", "8", "--steps", "2", "--buckets", "2", "--use-kernels",
        "--log-every", "1", "--device", "cpu"])
    model, _, _, _ = train.build(args)
    assert model.moe_dense
    out = train.run(args)
    assert np.isfinite(out["history"][-1]["loss"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_scheduler_serves_olmoe_as_the_reference():
    """Five requests through both packages' schedulers, two pairs of equal
    prompt lengths (one prefill batch each: the routed prefill's drops
    depend on the batch), whole-prompt, with decode bursts: equal greedy
    tokens."""
    jm, tm = _models(OLMOE)
    rng = np.random.default_rng(4)
    specs = [(rng.integers(0, V, n).tolist(), g)
             for n, g in ((12, 6), (12, 9), (20, 5), (7, 8), (7, 4))]
    out = []
    for sched, req, m, p in ((Scheduler, Request, tm,
                              params_from_numpy(_weights(OLMOE),
                                                device="cpu")),
                             (JScheduler, JRequest, jm,
                              jax.tree.map(jnp.asarray, _weights(OLMOE)))):
        sch = sched(m, p, slots=4, pages=24, page_size=8, max_len=32,
                    decode_burst=3)
        done = sch.run([req(rid=i, prompt=list(pr), max_new=g)
                        for i, (pr, g) in enumerate(specs)])
        out.append({r.rid: list(r.out) for r in done})
    assert out[0] == out[1]
    assert all(len(out[0][i]) == g for i, (_, g) in enumerate(specs))


def test_paged_decode_is_bitwise_the_dense_decode():
    """16 greedy steps of the reduced olmoe: the paged layout's logits
    are BITWISE the dense layout's at matched linearized cache length."""
    _, tm = _models(OLMOE)
    tp = params_from_numpy(_weights(OLMOE), device="cpu")
    B, P, gen, ps = 2, 8, 16, 8
    mp = -(-(P + gen + 1) // ps)
    toks = torch.from_numpy(_tokens((B, P), 5)).long()
    lay = DenseLayout(tm)
    logits, cache = lay.prefill(tp, {"tokens": toks}, cache_len=mp * ps)
    dense = [logits]
    for t in range(gen):
        logits, cache = lay.decode_step(tp, cache, {
            "tokens": dense[-1].argmax(-1)[:, None],
            "pos": torch.tensor(P + t)})
        dense.append(logits)
    pl = PagedLayout(tm, n_slots=B, num_pages=B * mp + 1, page_size=ps,
                     max_pages=mp)
    pages = torch.arange(1, B * mp + 1).reshape(B, mp)
    logits, cache = pl.prefill_into(tp, pl.init_cache(device="cpu"),
                                    {"tokens": toks},
                                    pages[:, :pl.pages_for(P)])
    assert torch.equal(logits, dense[0])
    pos = torch.full((B,), P)
    for t in range(gen):
        logits, cache = pl.decode_step(tp, cache,
                                       logits.argmax(-1)[:, None], pos,
                                       pages)
        assert torch.equal(logits, dense[t + 1]), f"step {t}"
        pos = pos + 1


def test_chunkable_refuses_routed_moe_and_accepts_moe_dense():
    for moe_dense in (False, True):
        jm, tm = _models(OLMOE, moe_dense)
        kw = dict(n_slots=1, num_pages=8, page_size=8, max_pages=4)
        assert PagedLayout(tm, **kw).chunkable == \
            JPagedLayout(jm, **kw).chunkable == moe_dense
    jm, tm = _models(OLMOE)
    with pytest.raises(NotImplementedError) as ours:
        Scheduler(tm, params_from_numpy(_weights(OLMOE), device="cpu"),
                  slots=1, pages=8, page_size=8, max_len=32, prefill_chunk=8)
    with pytest.raises(NotImplementedError) as theirs:
        JScheduler(jm, jax.tree.map(jnp.asarray, _weights(OLMOE)), slots=1,
                   pages=8, page_size=8, max_len=32, prefill_chunk=8)
    assert str(ours.value) == str(theirs.value)


def test_moe_dense_prefix_hit_is_bitwise_cold_and_the_reference_s():
    """Under ``moe_dense`` the layout is chunkable: three requests behind
    a shared 20-token prompt, served one after another; the prefix-cache
    run's greedy tokens are bitwise the cold chunked run's, and equal the
    reference's chunked run's."""
    jm, tm = _models(OLMOE, moe_dense=True)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, V, 20).tolist()
    prompts = [shared + rng.integers(1, V, 7).tolist() for _ in range(3)]
    runs = []
    for sched, req, m, p, hit in (
            (Scheduler, Request, tm,
             params_from_numpy(_weights(OLMOE), device="cpu"), False),
            (Scheduler, Request, tm,
             params_from_numpy(_weights(OLMOE), device="cpu"), True),
            (JScheduler, JRequest, jm,
             jax.tree.map(jnp.asarray, _weights(OLMOE)), False)):
        sch = sched(m, p, slots=2, pages=40, page_size=8, max_len=40,
                    prefill_chunk=16, prefix_cache=hit)
        for i, pr in enumerate(prompts):
            sch.run([req(rid=i, prompt=list(pr), max_new=6)])
        runs.append({r.rid: list(r.out) for r in sch.finished})
        if hit:
            assert sch.latency_summary()["prefix_hits"] >= 2
    assert runs[1] == runs[0] == runs[2]


# ---------------------------------------------------------------------------
# weights across packages
# ---------------------------------------------------------------------------


def test_expert_leaves_cross_both_ways(tmp_path):
    """The reduced olmoe's reference parameters convert to the port's
    tree and back bit for bit (the (E, d, f) expert leaves, the f32
    router), and a reference ``.npz`` restores in the port and a port
    ``.npz`` in the reference, bit for bit."""
    np_p = _weights(OLMOE)
    tp = params_from_numpy(np_p, device="cpu")
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(np_p), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    router = tp["stage0"]["b0"]["moe"]["router"]
    assert router.dtype == torch.float32 and tuple(router.shape) == (2, 256,
                                                                     4)
    assert tuple(tp["stage0"]["b0"]["moe"]["w_up"].shape) == (2, 4, 256,
                                                              128)
    like = Model(t_reduced(t_get_config(OLMOE))).init(
        torch.Generator().manual_seed(1))
    got = restore_pytree(j_save(tmp_path / "j.npz",
                                jax.tree.map(jnp.asarray, np_p)), like)
    for a, b in zip(jax.tree.leaves(np_p), T.leaves(got)):
        assert np.array_equal(a, b.numpy())
    t_path = save_pytree(tmp_path / "t.npz", tp)
    back = j_restore(t_path, jax.tree.map(jnp.zeros_like, np_p))
    for a, b in zip(jax.tree.leaves(np_p), jax.tree.leaves(back)):
        assert np.array_equal(a, np.asarray(b))
