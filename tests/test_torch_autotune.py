"""The autotuner (`repro_torch.analysis.autotune`), the launchers' tuned
configs and the kernel settings the tuner reaches:

* ``predict_train`` / ``predict_serve`` with the port's H100 constants
  patched to the reference's TPU values give the reference's
  predictions over both spaces (full and smoke);
* a blob in the reference's format drives both launchers'
  ``--tuned-config``;
* ``probe_serve`` on the reduced qwen3 gives identical greedy tokens
  across page_size {8, 16, 32} x decode_burst {1, 4}; ``probe_train`` and
  ``autotune`` on the CPU give a version-1 blob with tuned <= default;
* the tuned config is the best candidate only beyond the measured
  spread; a resumed run keeps its checkpoint's bucket layout over a
  tuned blob;
* B4's split-K design (the plain-torch model of its ranges and tiles) is
  bitwise the same for pages of 8, 16 and 32 tokens: the ranges are
  whole 32-token tiles, gathered token by token;
* ``gpu``: B4 at pages of 8 and 32 on bf16 and int8 pools against its
  plain version in float64 (1e-6 / 2e-5) and bitwise across the page
  sizes; A1 / A2 on buckets padded to 2·BLOCK (A1 rtol 1e-5, A2 bitwise).
"""
import json

import numpy as np
import pytest
import torch

from repro.analysis import autotune as j_tune
from repro.analysis import roofline as j_roofline
from repro.core import registry as jreg
from repro_torch.analysis import autotune as tune
from repro_torch.core import registry
from repro_torch.kernels import dc_update as K
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ref import paged_attention_plain
from repro_torch.models.cache import _quantize_tokens
from repro_torch.parallel import buckets as B
from test_torch_paged_attention import _split_merge
from torch_threads import one_torch_thread  # noqa: F401

SIZES = [151_936 * 1024, 1024 * 1024, 3072 * 1024, 1024, 7, 128, 256]


def _reference_constants(monkeypatch):
    monkeypatch.setattr(tune, "PEAK_FLOPS_BF16", j_roofline.PEAK_FLOPS_BF16)
    monkeypatch.setattr(tune, "HBM_BW", j_roofline.HBM_BW)
    monkeypatch.setattr(tune, "NVLINK_BW", j_roofline.ICI_BW)


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("smoke", [False, True])
def test_predict_train_matches_reference(smoke, wire, monkeypatch):
    _reference_constants(monkeypatch)
    ours_red = registry.make_reducer("mean_allreduce", comm_dtype=wire)
    theirs_red = jreg.make_reducer("mean_allreduce", comm_dtype=wire)
    space = tune.train_space(smoke)
    assert space == j_tune.train_space(smoke)
    for cand in space:
        for flops, hbm in ((0.0, 0.0), (3e12, 2e9)):
            assert tune.predict_train(
                cand, leaf_sizes=SIZES, n_workers=2, reducer=ours_red,
                flops=flops, hbm_bytes=hbm) == j_tune.predict_train(
                cand, leaf_sizes=SIZES, n_workers=2, reducer=theirs_red,
                flops=flops, hbm_bytes=hbm)


@pytest.mark.parametrize("smoke", [False, True])
def test_predict_serve_matches_reference(smoke, monkeypatch):
    _reference_constants(monkeypatch)
    space = tune.serve_space(smoke)
    assert space == j_tune.serve_space(smoke)
    for cand in space:
        for kw in (dict(kv_bytes_per_token=114_688, param_bytes=3_006_496_768,
                        slots=16, mean_len=360.0),
                   dict(kv_bytes_per_token=2048, param_bytes=10 ** 7,
                        slots=8, mean_len=20.0, decode_flops=1e9)):
            assert tune.predict_serve(cand, **kw) == \
                j_tune.predict_serve(cand, **kw)


def _reference_blob(path):
    """A blob in the reference's format (its ``ici_bw`` hardware key and
    candidate records), as its autotuner writes one."""
    blob = {"version": 1, "smoke": True,
            "hardware": {"peak_flops_bf16": 197e12, "hbm_bw": 819e9,
                         "ici_bw": 50e9},
            "train": {"default": {"buckets": 4, "plan_block": None},
                      "tuned": {"buckets": 2, "plan_block": 2 * B.BLOCK},
                      "default_ms": 10.0, "tuned_ms": 9.0,
                      "candidates": []},
            "serve": {"default": {"page_size": 16, "decode_burst": 4},
                      "tuned": {"page_size": 8, "decode_burst": 8},
                      "default_tps": 10.0, "tuned_tps": 12.0,
                      "candidates": []}}
    path.write_text(json.dumps(blob))
    assert j_tune.load_tuned(path) == tune.load_tuned(path)
    return path


def test_reference_blob_drives_the_train_launcher(tmp_path):
    from repro_torch.launch import train
    path = _reference_blob(tmp_path / "tuned.json")
    args = train.build_argparser().parse_args([
        "--reduced", "--steps", "1", "--workers", "2",
        "--batch-per-worker", "1", "--seq", "8", "--device", "cpu",
        "--tuned-config", str(path)])
    res = train.run(args)
    assert args.buckets == 2 and args.plan_block == 2 * B.BLOCK
    assert all(d.shape[-1] % (2 * B.BLOCK) == 0
               for d in res["state"].comm["delta_prev"])


def test_reference_blob_drives_the_serve_launcher(tmp_path):
    from repro_torch.launch import serve
    path = _reference_blob(tmp_path / "tuned.json")
    reqs = tmp_path / "r.jsonl"
    reqs.write_text('{"prompt_len": 6, "gen": 3}\n'
                    '{"prompt_len": 9, "gen": 2}\n')
    sch = serve.main(["--reduced", "--device", "cpu", "--requests",
                      str(reqs), "--slots", "2", "--pages", "16",
                      "--tuned-config", str(path)])
    assert sch.layout.page_size == 8 and sch.decode_burst == 8
    assert sorted(len(r.out) for r in sch.finished) == [2, 3]


def test_load_tuned_rejects_other_files(tmp_path):
    p = tmp_path / "x.json"
    p.write_text(json.dumps({"version": 2}))
    with pytest.raises(ValueError, match="version 1"):
        tune.load_tuned(p)


def test_serve_candidates_give_identical_greedy_tokens():
    cands = [{"page_size": p, "decode_burst": d}
             for p in (8, 16, 32) for d in (1, 4)]
    got = tune.probe_serve(cands, device="cpu")
    default = tune.SERVE_DEFAULT
    assert [r["config"] for r in got] == \
        [default] + [c for c in cands if c != default]
    assert all(r["tokens"] == got[0]["tokens"] > 0 for r in got)
    assert all(r["tokens_per_s"] > 0 and r["predicted_s_per_token"] > 0
               for r in got)


def test_serve_probe_raises_when_a_candidate_changes_tokens(monkeypatch):
    from repro_torch.serve import scheduler as S
    real = S.Scheduler.run

    def run(self, reqs, **kw):
        out = real(self, reqs, **kw)
        if self.layout.page_size == 8:
            self.finished[0].out[0] += 1
        return out

    monkeypatch.setattr(S.Scheduler, "run", run)
    with pytest.raises(RuntimeError, match="greedy tokens"):
        tune.probe_serve([{"page_size": 8, "decode_burst": 4}],
                         device="cpu", n_requests=4)


def test_autotune_blob_on_the_cpu(tmp_path):
    blob = tune.autotune(smoke=True, device="cpu", n_requests=4)
    assert blob["version"] == 1 and blob["device"] == "cpu"
    tr, sv = blob["train"], blob["serve"]
    assert tr["default"] == tune.TRAIN_DEFAULT
    assert tr["tuned_ms"] <= tr["default_ms"]
    assert sv["tuned_tps"] >= sv["default_tps"] and sv["tokens_identical"]
    assert {json.dumps(c["config"]) for c in tr["candidates"]} == \
        {json.dumps(c) for c in tune.train_space(True)}
    for c in tr["candidates"]:
        assert c["predicted_ms"] > c["predicted_comm_s"] * 1e3 > 0
    path = tmp_path / "t.json"
    path.write_text(json.dumps(blob))
    assert tune.load_tuned(path) == json.loads(json.dumps(blob))


def _records(key, samples, default_samples, best_samples, default_cfg):
    other = {k: (v * 2 if v else 2) for k, v in default_cfg.items()}
    return [{"config": dict(default_cfg), samples: default_samples,
             key: float(np.median(default_samples))},
            {"config": other, samples: best_samples,
             key: float(np.median(best_samples))}]


@pytest.mark.parametrize("side", ["train", "serve"])
@pytest.mark.parametrize("gain,adopted", [(0.5, False), (3.0, True)])
def test_a_winner_within_the_spread_is_not_adopted(side, gain, adopted):
    """The tuned config is the best candidate only where it beats the
    default by more than the larger range of the two
    candidates' samples (here 2.0); a gain inside it keeps the default."""
    noise = [-1.0, 1.0, -0.5, 0.5]                 # range 2.0
    if side == "train":
        d = [100.0 + x for x in noise]
        b = [100.0 - gain + x for x in noise]
        recs = _records("ms_per_step", "step_ms", d, b, tune.TRAIN_DEFAULT)
        entry = tune.train_entry(recs)
        margin = entry["margin_ms"]
    else:
        d = [50.0 + x for x in noise]
        b = [50.0 + gain + x for x in noise]
        recs = _records("tokens_per_s", "run_tps", d, b, tune.SERVE_DEFAULT)
        entry = tune.serve_entry(recs)
        margin = entry["margin_tps"]
    assert margin == pytest.approx(2.0)
    assert entry["adopted"] is adopted
    assert entry["tuned"] == recs[1 if adopted else 0]["config"]
    assert tune.spread([3.0, 1.0]) == 2.0


def test_resume_keeps_the_checkpoint_s_bucket_layout(tmp_path, capsys):
    """A run trained on a tuned layout (2 buckets padded to 2·BLOCK)
    records it in the checkpoint; resuming with another tuned blob (or
    none) keeps the checkpoint's layout and continues bitwise as the
    uninterrupted run."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint_meta
    from repro_torch.launch import train
    from repro_torch.launch.engine import algorithm_for_checkpoint
    tuned = _reference_blob(tmp_path / "tuned.json")
    other = json.loads(tuned.read_text())
    other["train"]["tuned"] = {"buckets": 4, "plan_block": None}
    other_path = tmp_path / "other.json"
    other_path.write_text(json.dumps(other))
    ckpt = tmp_path / "state.npz"

    def run(*extra):
        args = train.build_argparser().parse_args([
            "--reduced", "--layers", "1", "--workers", "2",
            "--batch-per-worker", "1", "--seq", "8", "--device", "cpu",
            "--seed", "3", *extra])
        return args, train.run(args)

    _, whole = run("--steps", "3", "--tuned-config", str(tuned))
    run("--steps", "2", "--tuned-config", str(tuned), "--ckpt", str(ckpt))
    meta = checkpoint_meta(ckpt)
    assert (meta["buckets"], meta["plan_block"]) == (2, 2 * B.BLOCK)
    alg, _ = algorithm_for_checkpoint(ckpt)
    assert (alg.buckets, alg.plan_block) == (2, 2 * B.BLOCK)
    for extra in (("--tuned-config", str(other_path)), ()):
        args, res = run("--steps", "3", "--resume", str(ckpt), *extra)
        assert (args.buckets, args.plan_block) == (2, 2 * B.BLOCK)
        assert res["start"] == 2 and res["state"].step == 3
        for x, y in zip(T.leaves(res["state"].params),
                        T.leaves(whole["state"].params)):
            assert torch.equal(x, y)
    assert "wins over the tuned config" in capsys.readouterr().out


def test_probe_train_top_k_keeps_the_default():
    got = tune.probe_train(tune.train_space(False), top_k=2, steps=1,
                           device="cpu")
    assert got[0]["config"] == tune.TRAIN_DEFAULT and len(got) == 3
    comm = [r["predicted_comm_s"] for r in got[1:]]
    assert comm == sorted(comm)


# ---------------------------------------------------------------------------
# B4 across page sizes
# ---------------------------------------------------------------------------


def _repaged(ps, *, B_=3, KV=2, G=2, hd=32, L=70, lengths=(1, 40, 70),
             seed=0):
    """The same rows' k / v token sequences laid into pages of ``ps``
    tokens through a shuffled block table: (q, k_pool, v_pool, table,
    lengths)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B_, KV, G, hd))
                         .astype(np.float32))
    ks = torch.from_numpy(rng.standard_normal((B_, L, KV, hd))
                          .astype(np.float32))
    vs = torch.from_numpy(rng.standard_normal((B_, L, KV, hd))
                          .astype(np.float32))
    mp = -(-L // ps)
    order = np.random.default_rng(ps).permutation(B_ * mp) + 1
    table = torch.from_numpy(order.reshape(B_, mp).astype(np.int32))
    k_pool = torch.zeros((B_ * mp + 1, ps, KV, hd))
    v_pool = torch.zeros_like(k_pool)
    for b in range(B_):
        for t in range(L):
            k_pool[table[b, t // ps], t % ps] = ks[b, t]
            v_pool[table[b, t // ps], t % ps] = vs[b, t]
    return q, k_pool, v_pool, table, torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize("splits", [1, 3, 16])
def test_split_design_is_bitwise_across_page_sizes(splits):
    outs = [_split_merge(*_repaged(ps), splits) for ps in (8, 16, 32)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    want = paged_attention_plain(*_repaged(16))
    torch.testing.assert_close(outs[0], want, rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_cuda_paged_attention_at_pages_8_and_32(pool):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    dev = torch.device("cuda")
    lens = tuple(1 + (i * 576) // 15 for i in range(16))
    got = {}
    for ps in (8, 16, 32):
        q, k, v, bt, ln = (t.to(dev) for t in _repaged(
            ps, B_=16, KV=8, G=2, hd=128, L=577, lengths=lens))
        if pool == "int8":
            k, ks = _quantize_tokens(k, "int8", 2)
            v, vs = _quantize_tokens(v, "int8", 2)
            kw, scales, atol = dict(k_scale=ks, v_scale=vs), (ks, vs), 2e-5
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
            kw, scales, atol = {}, (), 1e-6
        got[ps] = paged_attention(q, k, v, bt, ln, **kw)
        want = paged_attention_plain(
            q.double(), k, v, bt, ln,
            *(s.double() for s in scales)) if scales else \
            paged_attention_plain(q.double(), k, v, bt, ln)
        torch.cuda.synchronize()
        err = float((got[ps].double() - want.double()).abs().max())
        assert err <= atol, (pool, ps, err)
    assert torch.equal(got[8], got[16]) and torch.equal(got[32], got[16])


@pytest.mark.gpu
def test_cuda_dc_kernels_at_two_block_padding():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 3 * 2 * B.BLOCK
    g, d, m, w = (torch.randn((2, n), generator=gen, device=dev)
                  for _ in range(4))
    # the padding tail of a 2·BLOCK bucket is zero in every operand
    for t in (g, d, m, w):
        t[:, n - B.BLOCK - 5:] = 0
    lam = torch.tensor([0.3, 0.7], device=dev)
    args = dict(lam=lam, mu=0.9, eta=0.05, wd=2.3e-4)
    a = K.dc_norms(g, d)
    ref = K.dc_norms_plain(g, d)
    for x, r in zip(a, (ref[:, 0], ref[:, 1])):
        torch.testing.assert_close(x, r, rtol=1e-5, atol=0)
    out = K.dc_fused_update(g, d, m, w, **args)
    want = K.dc_fused_update_plain(g, d, m, w, **args)
    for x, r in zip(out, want):
        assert torch.equal(x, r)
    assert not out[0][:, n - B.BLOCK:].any()
