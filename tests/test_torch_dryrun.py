"""The port's dry-run (`repro_torch.launch.dryrun`) and its tables
(`repro_torch.analysis.report`).  Each dry-run runs in a subprocess of
its own: it starts the ``fake`` process group (256 / 512 ranks), and a
process holds one default group.  The configs are the reduced ones; the
full-size specs and bytes are `tests/test_torch_sharding.py`'s."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import registry as j_registry
from repro.core.api import MeshAxes as JMeshAxes
from repro.core.types import DCS3GDConfig as JDCS3GDConfig
from repro.core.types import INPUT_SHAPES as J_SHAPES
from repro.launch import specs as JS
from repro.models.transformer import Model as JModel

from repro_torch.analysis import report
from repro_torch.analysis.roofline import Roofline
from repro_torch.configs import get_config, reduced
from repro_torch.core import registry
from repro_torch.core.api import MeshAxes
from repro_torch.core.types import DCS3GDConfig, INPUT_SHAPES
from repro_torch.launch import specs as S
from repro_torch.models.transformer import Model
from repro_torch.parallel import sharding as shd

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
COMBOS = [("train_4k", "pod"), ("prefill_32k", "pod"), ("decode_32k", "pod"),
          ("decode_32k", "multipod")]
MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}
DC = dict(total_steps=10_000, warmup_steps=1_500)


def _python(code: str, cwd: Path):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=cwd, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The four combos of the reduced qwen3-0.6b, one process."""
    out = tmp_path_factory.mktemp("dryrun")
    calls = "".join(
        f"dryrun.run_one('qwen3-0.6b', {s!r}, {m!r}, out_dir=OUT, cut=True)\n"
        for s, m in COMBOS)
    r = _python("import torch; torch.set_num_threads(1)\n"
                "from pathlib import Path\n"
                "from repro_torch.launch import dryrun\n"
                f"OUT = Path({str(out)!r})\n" + calls, out)
    assert r.returncode == 0, r.stderr[-3000:]
    return out, {(s, m): json.loads(
        (out / f"qwen3-0.6b__{s}__{m}__dc_s3gd.json").read_text())
        for s, m in COMBOS}


def _reference_record_keys():
    """The keys of the record `repro.launch.dryrun.run_one` writes, read
    off its source (lowering there forces 512 XLA devices)."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            keys = [k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)]
            if "lower_s" in keys:
                mem = next(v for k, v in zip(node.value.keys,
                                             node.value.values)
                           if getattr(k, "value", None) == "memory")
                return set(keys), {k.value for k in mem.keys}
    raise AssertionError("no record in the reference's dry-run")


@pytest.mark.parametrize("shape,mesh", COMBOS,
                         ids=[f"{s}-{m}" for s, m in COMBOS])
def test_record_schema_is_the_reference_one(records, shape, mesh):
    _, recs = records
    rec = recs[(shape, mesh)]
    top, mem = _reference_record_keys()
    assert set(rec) == top
    assert mem <= set(rec["memory"])
    assert rec["status"] == "ok" and rec["variant"] == "qwen3-0.6b-smoke"
    assert rec["n_chips"] == (512 if mesh == "multipod" else 256)
    # one rank's peak: its inputs and the most its step holds beyond them
    m = rec["memory"]
    assert m["peak_bytes"] > m["argument_bytes"] > 0
    assert m["temp_bytes"] == m["peak_bytes"] - m["argument_bytes"]
    assert "MemTracker" in m["note"] and "not XLA's temp" in m["note"]
    from repro.analysis.roofline import Roofline as JRoofline
    fields = set(JRoofline.__dataclass_fields__)
    assert fields <= set(rec["roofline"]) and \
        set(Roofline.__dataclass_fields__) <= set(rec["roofline"])
    assert "worker-axis wire" in rec["roofline"]["note"]
    assert "one rank's step" in rec["roofline"]["note"]
    ro = rec["roofline"]
    assert ro["flops"] > 0 and ro["hbm_bytes"] > 0
    # one rank's step at 'model' 16: its collectives over 'model' are
    # priced beside the wire
    assert ro["tp_bytes"] > 0
    if shape == "train_4k":
        # the worker-axis wire: the rank's row's payload (its model
        # shard), slower over the network than over NVLink
        assert ro["coll_bytes"] > 0
        assert ro["collective_net_s"] == pytest.approx(
            ro["collective_s"] * 450 / 50)
    else:
        assert ro["coll_bytes"] == 0


def _port_inputs(shape_name):
    shape = INPUT_SHAPES[shape_name]
    cfg = S.variant_for_shape(S.dryrun_model_config(
        reduced(get_config("qwen3-0.6b"))), shape)
    return cfg, shape, Model(cfg, kernels=False)


@pytest.mark.parametrize("shape,mesh", COMBOS,
                         ids=[f"{s}-{m}" for s, m in COMBOS])
def test_argument_bytes_equal_the_spec_count(records, shape, mesh):
    """The record's per-device argument bytes are the local shards' bytes
    under the hooks' specs, counted here without a process group."""
    _, recs = records
    cfg, sh, model = _port_inputs(shape)
    sizes = MESHES[mesh]
    axes = MeshAxes(worker=tuple(a for a in sizes if a != "model"),
                    model="model", model_size=16)
    if sh.kind == "train":
        W = 16 if mesh == "pod" else 32
        alg = registry.make("dc_s3gd", DCS3GDConfig(**DC), n_workers=W)
        state = S.abstract_train_state(model, W, DCS3GDConfig(**DC), alg)
        batch = S.train_batch_specs(cfg, sh, W)
        want = shd.shard_bytes(state, alg.state_specs(cfg, state, axes),
                               sizes) + shd.shard_bytes(
            batch, alg.batch_specs(cfg, batch, axes), sizes)
    else:
        params = S.abstract_params(model)
        da = axes.worker_spec if sh.global_batch % 16 == 0 else None
        want = shd.shard_bytes(params, shd.param_specs(
            cfg, params, model_size=16), sizes)
        if sh.kind == "decode":
            cache = S.abstract_cache(model, sh)
            batch = S.decode_batch_specs(cfg, sh)
            want += shd.shard_bytes(cache, shd.cache_specs(
                cfg, cache, model_size=16, data_axes=da), sizes)
        else:
            batch = S.prefill_batch_specs(cfg, sh)
        want += shd.shard_bytes(batch, shd.batch_specs(
            cfg, batch, data_axes=da), sizes)
    assert recs[(shape, mesh)]["memory"]["argument_bytes"] == want


def test_train_argument_bytes_equal_the_reference_count(records):
    """The train record's argument bytes equal the reference's own
    spec-derived count of its reduced train state and batch (pod)."""
    _, recs = records
    jcfg = JS.dryrun_model_config(j_reduced(j_get_config("qwen3-0.6b")))
    jalg = j_registry.make("dc_s3gd", JDCS3GDConfig(**DC), n_workers=16)
    st = JS.abstract_train_state(JModel(jcfg, remat=True), 16,
                                 JDCS3GDConfig(**DC), jalg)
    batch = JS.train_batch_specs(jcfg, J_SHAPES["train_4k"], 16)
    axes = JMeshAxes(worker=("data",), model="model", model_size=16)
    total = 0
    for tree, specs in ((st, jalg.state_specs(jcfg, st, axes)),
                        (batch, jalg.batch_specs(jcfg, batch, axes))):
        for leaf, s in zip(jax.tree.leaves(tree), jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, P))):
            n = leaf.size
            for ax in tuple(s):
                names = () if ax is None else (
                    ax if isinstance(ax, tuple) else (ax,))
                for a in names:
                    n //= MESHES["pod"][a]
            total += n * leaf.dtype.itemsize
    assert recs[("train_4k", "pod")]["memory"]["argument_bytes"] == total


def test_roofline_table_renders(records):
    out, recs = records
    table = report.roofline_table("pod", str(out))
    rows = [r for r in table.splitlines() if r.startswith("| qwen3-0.6b")]
    assert len(rows) == 3
    assert all(r.count("|") == 11 and "| - |" not in r for r in rows)
    temps = [r.split("|")[9].strip() for r in rows]
    assert temps == [report.fmt_mem(recs[(s, "pod")]["memory"][
        "temp_bytes"]) for s in ("decode_32k", "prefill_32k", "train_4k")]
    assert "256 GPUs (16,16)" in table
    assert report.dryrun_summary("multipod", str(out)).startswith(
        "mesh `multipod`: 1 built + traced OK")
    assert report.fmt_mem(None) == "-" and report.fmt_mem(2 ** 31) == "2.0"
    rec = json.loads(json.dumps(recs[("decode_32k", "pod")]))
    rec.update(status="skipped", reason="not meaningful")
    (out / "x__long_500k__pod__dc_s3gd.json").write_text(json.dumps(rec))
    assert "*skipped: not meaningful*" in report.roofline_table(
        "pod", str(out))


def test_non_dividing_shape_writes_a_fail_record_and_exits_1(tmp_path):
    """A config whose FFN width (520) does not divide over the 16-wide
    model axis fails the type check: FAIL record, exit 1."""
    r = _python(
        "import dataclasses, torch; torch.set_num_threads(1)\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch import dryrun\n"
        "cfg = configs.reduced(configs.get_config('qwen3-0.6b'))\n"
        "configs.ARCHS['odd'] = dataclasses.replace(cfg, name='odd', "
        "d_ff=520)\n"
        "dryrun.main(['--arch', 'odd', '--shape', 'decode_32k', '--out', "
        f"{str(tmp_path)!r}])\n", tmp_path)
    assert r.returncode == 1, (r.stdout[-2000:], r.stderr[-2000:])
    assert "[dryrun] FAIL odd x decode_32k x pod" in r.stdout
    rec = json.loads((tmp_path / "odd__decode_32k__pod__dc_s3gd.json")
                     .read_text())
    assert rec["status"] == "fail" and "does not divide" in rec["reason"]
    assert "*fail:" in report.roofline_table("pod", str(tmp_path))


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_fake_trace_counts_what_a_real_trace_counts(kind):
    """The dry-run's roofline reads an op trace of fake tensors: its
    FLOPs and bytes equal a trace of the same step on real CPU tensors
    (a fake tensor's device query, ``prim.device``, moves nothing)."""
    import dataclasses
    import torch
    from repro_torch.analysis import optrace
    from repro_torch.launch.engine import Engine
    cfg = S.dryrun_model_config(reduced(get_config("qwen3-0.6b")))
    model = Model(cfg, kernels=False)
    shape = dataclasses.replace(INPUT_SHAPES[f"{kind}_32k" if kind ==
                                             "decode" else "train_4k"],
                                seq_len=64, global_batch=4)
    alg = registry.make("dc_s3gd", DCS3GDConfig(), n_workers=2)

    def run(params, cache, batch, state):
        if kind == "decode":
            with optrace.trace() as tr:
                model.decode_step(params, cache, batch)
            return tr
        return Engine(model, alg).trace_train_step(state, batch)[0]

    fake_batch = S.decode_batch_specs(cfg, shape) if kind == "decode" \
        else S.train_batch_specs(cfg, shape, 2)
    with S.fake_mode():
        fake = run(S.abstract_params(model), S.abstract_cache(model, shape),
                   fake_batch,
                   S.abstract_train_state(model, 2, DCS3GDConfig(), alg))
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device=torch.device("cpu"))
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in fake_batch.items()}
    real = run(params, cache, batch, alg.init(params))
    assert fake.bytes == real.bytes and fake.flops == real.flops
    assert not [o for o in fake.ops if o.name.startswith("prim.device")
                and o.bytes_read + o.bytes_written]


def test_fake_peak_is_the_real_tensors_peak():
    """The dry-run's ``peak_bytes`` (`dryrun.traced_peak` around the
    traced step on fake tensors) is, to the byte, the same tracker's peak
    around the same step of the reduced qwen3 (remat on, as the dry-run
    builds it; 64 tokens, W = 2) on real CPU tensors."""
    import dataclasses
    import torch
    from repro_torch.launch.dryrun import traced_peak
    from repro_torch.launch.engine import Engine
    cfg = S.dryrun_model_config(reduced(get_config("qwen3-0.6b")))
    model = Model(cfg, remat=True, kernels=False)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=64,
                                global_batch=4)
    alg = registry.make("dc_s3gd", DCS3GDConfig(), n_workers=2)
    engine = Engine(model, alg)
    fake_batch = S.train_batch_specs(cfg, shape, 2)
    with S.fake_mode():
        state = S.abstract_train_state(model, 2, DCS3GDConfig(), alg)
        _, fake = traced_peak(
            lambda: engine.trace_train_step(state, fake_batch),
            (state, fake_batch))
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in fake_batch.items()}
    real_state = alg.init(params)
    del params
    _, real = traced_peak(lambda: engine.trace_train_step(real_state, batch),
                          (real_state, batch))
    assert fake == real > 0


def test_pod_one_rank_decode_collectives_are_the_hand_count(tmp_path):
    """On the production pod mesh (16, 16) the dry-run traces rank 0's
    decode step at 'model' 16: the reduced qwen3 (bf16, heads padded to
    16, its 2 KV heads whole, so its cache shards by position), decode_32k
    (128 rows over 16 data ranks: b = 8 a rank; a 32,768-position
    cache).  Its ``tp`` payload by hand: the embedding's sum (b·d bf16),
    each layer's two row-parallel sums (b·d f32), the rank's vocabulary
    columns gathered (b·V/16 f32) and each layer's k and v blocks
    gathered for the attend (b·C/16·KV·2·hd bf16)."""
    out = tmp_path / "dr"
    r = _python("import torch; torch.set_num_threads(1)\n"
                "from pathlib import Path\n"
                "from repro_torch.launch import dryrun\n"
                f"dryrun.run_one('qwen3-0.6b', 'decode_32k', 'pod', "
                f"out_dir=Path({str(out)!r}), cut=True)\n", tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((out / "qwen3-0.6b__decode_32k__pod__dc_s3gd.json")
                     .read_text())
    cfg = S.dryrun_model_config(reduced(get_config("qwen3-0.6b")))
    shape = INPUT_SHAPES["decode_32k"]
    b, C = shape.global_batch // 16, shape.seq_len
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.resolved_head_dim
    KV = cfg.eff_n_kv_heads
    vp = -(-cfg.vocab_size // 256) * 256
    assert (cfg.eff_n_heads, KV) == (16, 2)
    want = (b * d * 2 + L * 2 * b * d * 4 + b * (vp // 16) * 4
            + L * b * (C // 16) * KV * 2 * hd * 2)
    ro = rec["roofline"]
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert ro["tp_bytes"] == want
    assert ro["collective_tp_s"] == pytest.approx(want / 450e9)


def test_tensor_parallel_collectives_are_the_hand_count(tmp_path):
    """On a (1, 2) fake mesh the dry-run traces one rank's
    tensor-parallel step of the reduced qwen3 (bf16, 2 layers, W = 1) at
    train_4k (b 256, S 4,096) and prices the collectives of its ``tp``
    scope.  Their payload, counted by hand: forward, the embedding's sum
    (b·S·d bf16) and each layer's two row-parallel sums (attention's
    ``wo``, the MLP's ``w_down``: f32); backward, the input of each
    column-parallel product (a layer's q, k, v, up and gate; the loss's
    unembedding: bf16), the q / k norm scales (hd bf16 each); per loss
    chunk of 2,048 positions, the max (b·c f32) and the
    exponential sums with the label logits (2·b·c f32); the Eq. 17 and
    metric norms (two (2, W) f32 sums).  The dry-run's train Model
    rematerialises each layer in the backward pass, which issues its
    attention's row-parallel sum again (the recompute stops at the MLP's
    ``w_down``, the last product whose input the backward reads, before
    the MLP's sum), and each checkpointed loss chunk, which issues the
    chunk's max and sums again."""
    out = tmp_path / "dr"
    r = _python("import torch; torch.set_num_threads(1)\n"
                "from pathlib import Path\n"
                "from repro_torch.launch import dryrun\n"
                f"dryrun.run_one('qwen3-0.6b', 'train_4k', '1x2', "
                f"out_dir=Path({str(out)!r}), cut=True)\n", tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((out / "qwen3-0.6b__train_4k__1x2__dc_s3gd.json")
                     .read_text())
    cfg = reduced(get_config("qwen3-0.6b"))
    shape = INPUT_SHAPES["train_4k"]
    b, s, d, L = shape.global_batch, shape.seq_len, cfg.d_model, \
        cfg.n_layers
    hd, chunk, W = cfg.resolved_head_dim, 2048, 1
    act16, act32 = b * s * d * 2, b * s * d * 4
    forward = act16 + L * 2 * act32
    # each column-parallel product's input: q, k, v, up, gate
    backward = L * 5 * act16 + act16 + L * 2 * hd * 2
    loss = (s // chunk) * (b * chunk * 4 + 2 * b * chunk * 4)
    norms = 2 * (2 * W * 4)
    recompute = L * act32 + loss
    ro = rec["roofline"]
    assert rec["status"] == "ok" and rec["n_chips"] == 2
    assert ro["tp_bytes"] == forward + backward + loss + norms + recompute
    assert ro["collective_tp_s"] == pytest.approx(ro["tp_bytes"] / 450e9)
    assert ro["coll_breakdown"]["tp"] == ro["tp_bytes"]
    assert "tensor-parallel" in ro["note"]


def test_tensor_parallel_decode_collectives_are_the_hand_count(tmp_path):
    """On a (1, 2) fake mesh the dry-run traces one rank's serving decode
    step at decode_32k (b 128, a 32,768-position cache, bf16) through an
    Engine without an algorithm, on the rank's serve shards, batch and
    cache shard, and prices its ``tp`` collectives.  By hand: the
    embedding's sum (b·d bf16), each layer's two row-parallel sums
    (``wo``, ``w_down``: b·d f32), the rank's vocabulary columns gathered
    (b·V/2 f32); granite (one KV head, its cache by position) adds each
    layer's k and v blocks gathered for the attend (b·C/2·KV·2·hd
    bf16), the reduced qwen3 (its cache by KV head) nothing."""
    out = tmp_path / "dr"
    r = _python("import torch; torch.set_num_threads(1)\n"
                "from pathlib import Path\n"
                "from repro_torch.launch import dryrun\n"
                + "".join(f"dryrun.run_one({a!r}, 'decode_32k', '1x2', "
                          f"out_dir=Path({str(out)!r}), cut=True)\n"
                          for a in ("qwen3-0.6b", "granite-20b")), tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    shape = INPUT_SHAPES["decode_32k"]
    b, C = shape.global_batch, shape.seq_len
    for arch, by_position in (("qwen3-0.6b", False), ("granite-20b", True)):
        rec = json.loads((out / f"{arch}__decode_32k__1x2__dc_s3gd.json")
                         .read_text())
        cfg = reduced(get_config(arch))
        d, L, hd = cfg.d_model, cfg.n_layers, cfg.resolved_head_dim
        vp = -(-cfg.vocab_size // 256) * 256
        want = b * d * 2 + L * 2 * b * d * 4 + b * (vp // 2) * 4
        if by_position:
            want += L * b * (C // 2) * cfg.n_kv_heads * 2 * hd * 2
        ro = rec["roofline"]
        assert rec["status"] == "ok" and rec["n_chips"] == 2
        assert ro["tp_bytes"] == want, arch
        assert ro["collective_tp_s"] == pytest.approx(want / 450e9)


# (DRYRUN_REDUCER, DRYRUN_COMM_DTYPE) of the wires whose result depends on
# the bucket or leaf they reduce: bucketed topk (the dry-run's 4 buckets)
# and the per-leaf int8 mean
WHOLE_WIRES = (("topk", "float32"), ("mean_allreduce", "int8"))


def test_tensor_parallel_wire_is_the_whole_plans(tmp_path):
    """On a (1, 2) fake mesh a compressed or quantized wire reduces the
    whole buckets (leaves): the dry-run's wire is the one-process one's
    (``mesh`` 1x1, the same config), and its ``tp`` collectives grow by
    the gather of the rank's payload (each model-sharded leaf's local
    f32 delta of its one worker row), printed on the record's ``wire``
    line."""
    out = tmp_path / "dr"
    calls = "".join(
        f"os.environ.update(DRYRUN_REDUCER={red!r}, "
        f"DRYRUN_COMM_DTYPE={dt!r})\n"
        + "".join(f"shutil.rmtree(OUT, ignore_errors=True)\n"
                  f"rec = dryrun.run_one('qwen3-0.6b', 'train_4k', {m!r}, "
                  f"out_dir=OUT, cut=True)\n"
                  f"print('REC', {red!r}, {dt!r}, {m!r}, "
                  f"json.dumps(rec['roofline']['coll_breakdown']))\n"
                  for m in ("1x2", "1x1"))
        for red, dt in WHOLE_WIRES + (("mean_allreduce", "float32"),))
    r = _python("import json, os, shutil, torch\n"
                "torch.set_num_threads(1)\n"
                "from pathlib import Path\n"
                "from repro_torch.launch import dryrun\n"
                f"OUT = Path({str(out)!r})\n" + calls, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = {tuple(ln.split()[1:4]): json.loads(ln.split(maxsplit=4)[4])
            for ln in r.stdout.splitlines() if ln.startswith("REC ")}
    gathered = [int(ln.rsplit(":", 1)[1].split()[0])
                for ln in r.stdout.splitlines()
                if ln.strip().startswith("wire:")]
    cfg = S.variant_for_shape(S.dryrun_model_config(
        reduced(get_config("qwen3-0.6b")), model_axis=2),
        INPUT_SHAPES["train_4k"])
    params = S.abstract_params(Model(cfg))
    flags = shd.sharded_over_model(cfg, params, model_size=2)
    leaves = [x for x in shd.leaves_with_path(params)]
    want = sum(x.numel() // 2 * 4 for (_, x), f in zip(leaves, flags) if f)
    assert want > 0
    # the wire line of each run (1x2, then 1x1): the two whole wires'
    # gathers over 'model', nothing gathered on 1x1 nor for the plain mean
    assert gathered == [want, 0, want, 0, 0, 0]
    plain = recs[("mean_allreduce", "float32", "1x2")]
    for red, dt in WHOLE_WIRES:
        tp, one = recs[(red, dt, "1x2")], recs[(red, dt, "1x1")]
        assert tp["wire"] == one["wire"] > 0, red
        assert tp["tp"] == plain["tp"] + want, red
