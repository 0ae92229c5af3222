"""Checkpoints (`repro_torch.checkpoint`, ``Engine.save`` / ``restore``,
`algorithm_for_checkpoint`, train ``--ckpt`` / ``--resume``, serve
``--train-ckpt``) in the reference's file format, held against the
reference.

* The format: leaf names are JAX's ``keystr`` paths and dtypes its numpy
  names, equal to the reference's for the same state; a bf16 leaf the
  reference wrote (a ``V2`` array) reads back in the port bit for bit, and
  the port writes the same bytes.
* Across packages, on the reduced ResNet of ``examples/cnn_paper_repro.py``
  (W = 4, 4 buckets, f32, the §IV-A-style hyper-parameters of
  ``tests/test_torch_cnn.py``): a reference checkpoint after 3 steps
  restores into the port bit for bit and 3 more port steps track the
  reference's continuation within ``tests/test_torch_cnn.py``'s
  tolerances (params rtol 1e-5 / atol 1e-4 of each leaf's largest update
  over the continuation; m and delta_prev atol 1e-4 of the leaf's largest
  magnitude; metrics rtol 1e-5); a port checkpoint restores into the
  reference bit for bit and continues there at the same tolerances.
* Within the port, bitwise: resume == uninterrupted (the prefetch cursor,
  the schedules and the pipeline all follow the checkpoint's step), and
  serving a training checkpoint serves ``eval_params``.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_problems as P
from repro.checkpoint import restore_pytree as j_restore
from repro.checkpoint import save_pytree as j_save
from repro.checkpoint.store import _flatten_with_names as j_names
from repro.core import registry as jreg
from repro.core.types import DCS3GDConfig as JConfig
from repro.data import SyntheticImageDataset as JImages
from repro.data import worker_batches as j_worker_batches
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import algorithm_for_checkpoint as j_for_ckpt
from repro.models import cnn as J
from repro_torch import tree as T
from repro_torch.checkpoint import (checkpoint_exists, checkpoint_meta,
                                    checkpoint_step, restore_pytree,
                                    save_pytree)
from repro_torch.core import registry as treg
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.data.pipeline import SyntheticImageDataset
from repro_torch.data.pipeline import worker_batches as t_worker_batches
from repro_torch.examples import cnn_paper_repro as twin
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve, train
from repro_torch.launch.engine import Engine, algorithm_for_checkpoint
from repro_torch.models import cnn as C
from torch_threads import one_torch_thread  # noqa: F401

W, BPW = 4, 16
NET = dict(stages=(1, 1), width=8, n_classes=8)
HP = dict(learning_rate=0.4, momentum=0.9, lambda0=0.2, weight_decay=1e-4,
          warmup_steps=1, total_steps=6)
FORMS = {"bucketed": dict(buckets=4), "fused_bucketed":
         dict(buckets=4, use_kernels=True)}
METRICS = ("loss", "lambda", "distance_norm", "delta_norm")


def _raw_meta(path):
    with np.load(path) as data:
        return json.loads(str(data["__meta__"]))


# --- the store ---------------------------------------------------------------


def test_round_trip_keeps_values_types_devices_and_step(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int32),
                  "h": np.array([3, 4], np.int32), "n": 5},
            "l": [torch.tensor([1.5, -2.25], dtype=torch.bfloat16)]}
    path = save_pytree(tmp_path / "ck", tree, step=7)
    assert path.name == "ck.npz"
    assert checkpoint_exists(tmp_path / "ck") and checkpoint_exists(path)
    assert checkpoint_step(tmp_path / "ck") == 7
    like = T.map(lambda x: torch.zeros_like(x)
                 if isinstance(x, torch.Tensor) else x, tree)
    like["b"]["h"], like["b"]["n"] = np.zeros(2, np.int32), 0
    out = restore_pytree(path, like)
    assert P.bitwise(out, tree)
    assert isinstance(out["b"]["n"], int) and out["b"]["n"] == 5
    assert isinstance(out["b"]["h"], np.ndarray)
    assert out["l"][0].dtype == torch.bfloat16
    meta = _raw_meta(path)
    assert meta["names"] == ["['a']", "['b']['c']", "['b']['h']",
                             "['b']['n']", "['l'][0]"]
    assert meta["dtypes"] == ["float32", "int32", "int32", "int32",
                              "bfloat16"]


def test_structure_mismatch_raises(tmp_path):
    path = save_pytree(tmp_path / "ck.npz", {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_pytree(path, {"zz": torch.zeros(2)})


def test_dtype_mismatch_raises_or_casts(tmp_path):
    path = save_pytree(tmp_path / "dt.npz",
                       {"m": torch.ones((2, 3)),
                        "s": torch.tensor([1, 2], dtype=torch.int32)})
    like = {"m": torch.zeros((2, 3), dtype=torch.bfloat16),
            "s": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="dtype mismatch"):
        restore_pytree(path, like)
    out = restore_pytree(path, like, cast_dtypes=True)
    assert out["m"].dtype == torch.bfloat16 and out["s"].dtype == torch.int32
    assert torch.equal(out["m"].float(), torch.ones((2, 3)))


def test_worker_count_change_names_the_elastic_resume(tmp_path):
    alg = treg.make("dc_s3gd", TConfig(), n_workers=8, buckets=2)
    state = alg.init(params_from_numpy(P.init(), device="cpu"))
    path = Engine(None, alg).save(tmp_path / "w8", state, step=0)
    wrong = treg.make("dc_s3gd", TConfig(), n_workers=6, buckets=2).init(
        params_from_numpy(P.init(), device="cpu"))
    with pytest.raises(ValueError, match="worker-count change"):
        restore_pytree(path, wrong)


STATES = {
    "per_leaf": ("dc_s3gd", {}),
    "bucketed_topk_overlap": ("dc_s3gd", dict(buckets=2, reducer="topk",
                                              overlap=True)),
    "randk_dynamic_ssp": ("dc_s3gd", dict(buckets=2, reducer="randk",
                                          staleness="dynamic_ssp")),
    "adam": ("dc_s3gd", dict(local_optimizer="adam")),
    "ssgd_powersgd": ("ssgd", dict(buckets=2, reducer="powersgd")),
    "dc_asgd": ("dc_asgd", {}),
}


@pytest.mark.parametrize("name", sorted(STATES))
def test_names_and_dtypes_are_the_reference_s(tmp_path, name):
    """The same algorithm after one step in both packages: the port's file
    names every leaf and dtype as the reference's own writer does."""
    algo, kw = STATES[name]
    t_alg = treg.make(algo, TConfig(), n_workers=3, **kw)
    j_alg = jreg.make(algo, JConfig(), n_workers=3, **kw)
    ts = t_alg.init(params_from_numpy(P.init(), device="cpu"))
    js = j_alg.init(jax.tree.map(jnp.asarray, P.init()))
    ts, _ = t_alg.step(ts, P.t_batch(0, 3), loss_fn=P.t_loss)
    js, _ = j_alg.step(js, P.j_batch(0, 3), loss_fn=P.j_loss)
    meta = _raw_meta(save_pytree(tmp_path / "t.npz", ts))
    names, leaves, _ = j_names(js)
    assert meta["names"] == names
    assert meta["dtypes"] == [str(np.asarray(x).dtype) for x in leaves]


def test_a_reference_bf16_leaf_reads_in_the_port(tmp_path):
    """The reference writes a bf16 array as 2-byte voids (``|V2``) beside
    its ``"bfloat16"`` dtype entry; the port reads it through that entry
    and writes the same bytes."""
    bits = np.array([0x3FC0, 0xC010, 0x0001, 0x7F80], np.uint16)
    j_tree = {"w": jnp.asarray(bits.view(jnp.bfloat16)),
              "x": jnp.arange(3, dtype=jnp.float32)}
    j_path = j_save(tmp_path / "j.npz", j_tree)
    like = {"w": torch.zeros(4, dtype=torch.bfloat16), "x": torch.zeros(3)}
    out = restore_pytree(j_path, like)
    assert out["w"].dtype == torch.bfloat16
    assert out["w"].view(torch.int16).numpy().view(np.uint16).tolist() == \
        bits.tolist()
    t_path = save_pytree(tmp_path / "t.npz", out)
    with np.load(j_path) as a, np.load(t_path) as b:
        assert a["leaf_0"].dtype == b["leaf_0"].dtype == np.dtype("V2")
        assert a["leaf_0"].tobytes() == b["leaf_0"].tobytes()
        assert json.loads(str(a["__meta__"])) == \
            json.loads(str(b["__meta__"]))


# --- the algorithm a checkpoint records --------------------------------------


def test_metadata_wins_over_flags(tmp_path):
    cfg = TConfig(local_optimizer="lars", ssp_threshold=7)
    red = treg.make_reducer("hierarchical", cfg, comm_dtype="bfloat16",
                            groups=2, neighbors=2)
    alg = treg.make("dc_s3gd", cfg, n_workers=4, reducer=red,
                    staleness="dynamic_ssp", buckets=2)
    state = alg.init(params_from_numpy(P.init(), device="cpu"))
    path = Engine(None, alg).save(tmp_path / "ck", state, step=0)
    rebuilt, resolved = algorithm_for_checkpoint(
        path, algo="ssgd", n_workers=2, local_optimizer="adam",
        reducer="gossip", staleness="fixed", buckets=0)
    assert (resolved["algo"], resolved["n_workers"], resolved["buckets"]) \
        == ("dc_s3gd", 4, 2)
    assert rebuilt.reducer.name == "hierarchical"
    assert rebuilt.reducer.hparams == red.hparams
    assert rebuilt.local_optimizer.name == "lars"
    assert rebuilt.staleness.name == "dynamic_ssp"
    assert rebuilt.staleness.threshold == 7
    assert P.bitwise(restore_pytree(path, rebuilt.init(
        params_from_numpy(P.init(), device="cpu"))), state)
    # the same metadata through the training entry point's flags
    args = train.build_argparser().parse_args(
        ["--resume", str(path), "--algo", "ssgd", "--reducer", "gossip"])
    train._adopt_resume_meta(args)
    assert (args.algo, args.reducer, args.workers, args.buckets,
            args.staleness, args.ssp_threshold, args.local_optimizer) == \
        ("dc_s3gd", "hierarchical", 4, 2, "dynamic_ssp", 7, "lars")
    assert args.reducer_opts == red.hparams
    # the reference reads the port's metadata the same way
    _, j_resolved = j_for_ckpt(path)
    assert j_resolved == resolved


def test_a_file_without_metadata_falls_back_to_the_flags(tmp_path):
    alg = treg.make("stale", TConfig(), n_workers=3)
    state = alg.init(params_from_numpy(P.init(), device="cpu"))
    path = save_pytree(tmp_path / "old.npz", state, step=0)
    assert checkpoint_meta(path) == {"step": 0}
    rebuilt, resolved = algorithm_for_checkpoint(path, algo="stale",
                                                 n_workers=3)
    assert rebuilt.name == "stale" and resolved["n_workers"] == 3
    assert P.bitwise(restore_pytree(path, rebuilt.init(
        params_from_numpy(P.init(), device="cpu"))), state)


# --- across packages: the reduced ResNet ------------------------------------


@functools.lru_cache(maxsize=None)
def _weights():
    return jax.tree.map(np.asarray,
                        J.init_resnet(jax.random.PRNGKey(0), **NET))


def _j_steps(alg, state, steps):
    step = jax.jit(functools.partial(alg.step,
                                     loss_fn=J.cnn_loss_fn(J.resnet_apply)))
    data = JImages(8, image_size=16, seed=0, noise=0.4)
    hist = []
    for t in steps:
        state, m = step(state, j_worker_batches(data, t, W, BPW))
        hist.append({k: float(m[k]) for k in METRICS})
    return state, hist


def _t_steps(alg, state, steps):
    data = SyntheticImageDataset(8, image_size=16, seed=0, noise=0.4)
    loss_fn = C.cnn_loss_fn(C.resnet_apply)
    hist = []
    for t in steps:
        state, m = alg.step(state, t_worker_batches(data, t, W, BPW,
                                                    device="cpu"),
                            loss_fn=loss_fn)
        hist.append({k: float(m[k]) for k in METRICS})
    return state, hist


def _assert_continuations_close(t_state, j_state, j_start, t_hist, j_hist):
    for x, y, z in zip(T.leaves(t_state.params),
                       jax.tree.leaves(j_state.params),
                       jax.tree.leaves(j_start.params)):
        y = np.asarray(y)
        np.testing.assert_allclose(
            x.numpy(), y, rtol=1e-5,
            atol=1e-4 * float(np.abs(y - np.asarray(z)).max()),
            err_msg="params")
    for key, ours, theirs in (("m", t_state.opt["m"], j_state.opt["m"]),
                              ("delta_prev", t_state.comm["delta_prev"],
                               j_state.comm["delta_prev"])):
        for x, y in zip(T.leaves(ours), jax.tree.leaves(theirs)):
            y = np.asarray(y)
            np.testing.assert_allclose(x.numpy(), y, rtol=1e-5,
                                       atol=1e-4 * float(np.abs(y).max()),
                                       err_msg=key)
    for th, jh in zip(t_hist, j_hist):
        for k in METRICS:
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_a_reference_checkpoint_continues_in_the_port(tmp_path, form):
    j_alg = jreg.make("dc_s3gd", JConfig(**HP), n_workers=W, **FORMS[form])
    j_state, _ = _j_steps(j_alg, j_alg.init(
        jax.tree.map(jnp.asarray, _weights())), range(3))
    path = JEngine(None, j_alg).save(tmp_path / "j.npz", j_state, step=3)
    t_alg, resolved = algorithm_for_checkpoint(path, dc_cfg=TConfig(**HP))
    assert resolved["buckets"] == 4 and resolved["n_workers"] == W
    t_alg.use_kernels = form == "fused_bucketed"
    t_state = restore_pytree(path, t_alg.init(
        params_from_numpy(_weights(), device="cpu")))
    assert t_state.step == 3
    assert P.bitwise(P.to_numpy(t_state)[:3],
                     jax.tree.map(np.asarray, tuple(j_state)[:3]))
    j_end, j_hist = _j_steps(j_alg, j_state, range(3, 6))
    t_end, t_hist = _t_steps(t_alg, t_state, range(3, 6))
    assert t_end.step == int(j_end.step) == 6
    _assert_continuations_close(t_end, j_end, j_state, t_hist, j_hist)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_a_port_checkpoint_continues_in_the_reference(tmp_path, form):
    t_alg = treg.make("dc_s3gd", TConfig(**HP), n_workers=W, **FORMS[form])
    t_state, _ = _t_steps(t_alg, t_alg.init(
        params_from_numpy(_weights(), device="cpu")), range(3))
    path = Engine(None, t_alg).save(tmp_path / "t.npz", t_state, step=3)
    j_alg, _ = j_for_ckpt(path, dc_cfg=JConfig(**HP))
    j_alg.use_kernels = form == "fused_bucketed"
    j_state = j_restore(path, j_alg.init(jax.tree.map(jnp.asarray,
                                                      _weights())))
    assert int(j_state.step) == 3
    assert P.bitwise(P.to_numpy(t_state)[:3],
                     jax.tree.map(np.asarray, tuple(j_state)[:3]))
    j_end, j_hist = _j_steps(j_alg, j_state, range(3, 6))
    t_end, t_hist = _t_steps(t_alg, t_state, range(3, 6))
    _assert_continuations_close(t_end, j_end, j_state, t_hist, j_hist)


# --- within the port: resume == uninterrupted -------------------------------


RESUMED = {
    "fused_bucketed": dict(buckets=4, use_kernels=True),
    "overlap_topk": dict(buckets=4, use_kernels=True, overlap=True,
                         reducer="topk"),
    "randk_dynamic_ssp": dict(buckets=4, reducer="randk",
                              staleness="dynamic_ssp"),
    "adam_per_leaf": dict(local_optimizer="adam"),
}


@pytest.mark.parametrize("name", sorted(RESUMED))
def test_resume_is_bitwise_uninterrupted(tmp_path, name):
    """The example twin for 6 steps, against 3 steps, a checkpoint, a
    fresh build at start=3, the restore and steps 3-5: every leaf of the
    final state and every loss equal."""
    kw = RESUMED[name]

    def fit(start, stop, state=None, path=None):
        model, alg, fresh, batch_fn, _ = twin.build(
            "dc_s3gd", twin.recipe(W, 6), W, 6, device="cpu",
            params=_weights(), start=start, **kw)
        engine = Engine(model, alg)
        if path is not None:
            state = engine.restore(path, fresh)
        state, hist, _ = engine.fit(state if state is not None else fresh,
                                    batch_fn, steps=stop, start=start,
                                    log_every=1)
        return engine, state, hist

    _, whole, whole_hist = fit(0, 6)
    engine, half, _ = fit(0, 3)
    path = engine.save(tmp_path / "half", half, step=3)
    _, resumed, resumed_hist = fit(3, 6, path=path)
    assert resumed.step == whole.step == 6
    assert P.bitwise(resumed, whole)
    assert [h["loss"] for h in resumed_hist] == \
        [h["loss"] for h in whole_hist[3:]]


def test_batch_fn_follows_start_and_the_worker_count():
    *_, batch_fn, ds = twin.build("dc_s3gd", twin.recipe(4, 6), 4, 6,
                                  device="cpu", start=2)
    b2 = batch_fn(2, 3)
    assert b2["images"].shape[0] == 3
    want = t_worker_batches(ds, 2, 3, twin.PER_WORKER, device="cpu")
    assert torch.equal(b2["images"], want["images"])
    b3 = batch_fn(3, 6)
    assert torch.equal(b3["labels"], t_worker_batches(
        ds, 3, 6, twin.PER_WORKER, device="cpu")["labels"])
    with pytest.raises(ValueError, match="out of step order"):
        batch_fn(5)


# --- the entry points ---------------------------------------------------------


def _train(tmp_path, *extra):
    args = train.build_argparser().parse_args(
        ["--reduced", "--layers", "1", "--batch-per-worker", "2", "--seq",
         "16", "--log-every", "1", "--buckets", "2", "--use-kernels",
         "--seed", "1", *extra])
    return train.run(args, device="cpu")


def test_train_ckpt_resume_and_elastic_resume(tmp_path, capsys):
    ckpt = tmp_path / "state.npz"
    first = _train(tmp_path, "--steps", "2", "--workers", "2", "--overlap",
                   "--ckpt", str(ckpt))
    assert checkpoint_meta(ckpt)["overlap"] is True
    # the checkpoint's algorithm wins over the re-passed flags
    resumed = _train(tmp_path, "--steps", "4", "--resume", str(ckpt),
                     "--reducer", "gossip")
    assert resumed["start"] == 2 and resumed["workers"] == 2
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    assert resumed["state"].step == 4 and "pipeline" in \
        resumed["state"].comm
    assert "resume metadata" in capsys.readouterr().out
    # an explicit other --workers reshards, keeping the consensus, and
    # trains on at the new count
    elastic = _train(tmp_path, "--steps", "2", "--resume", str(ckpt),
                     "--workers", "3")
    assert elastic["workers"] == 3 and elastic["history"] == []
    assert all(x.shape[0] == 3 for x in T.leaves(elastic["state"].params))
    alg, _ = algorithm_for_checkpoint(ckpt)
    assert P.bitwise(alg.eval_params(first["state"]),
                     alg.eval_params(elastic["state"]))
    on = _train(tmp_path, "--steps", "3", "--resume", str(ckpt),
                "--workers", "3")
    assert [h["step"] for h in on["history"]] == [2]
    assert np.isfinite(on["final_loss"])


def test_train_elastic_flags_and_transition_log(tmp_path):
    faults = tmp_path / "faults.json"
    faults.write_text(json.dumps({"seed": 0, "events": [
        {"step": 1, "kind": "leave"}, {"step": 2, "kind": "join"}]}))
    log = tmp_path / "log.json"
    result = _train(tmp_path, "--steps", "3", "--workers", "3",
                    "--reducer", "topk", "--fault-schedule", str(faults),
                    "--dense-after-join", "1", "--transition-log", str(log))
    kinds = [e["kind"] for e in result["transitions"]]
    assert kinds == ["leave", "join", "dense_window_start"]
    assert json.loads(log.read_text()) == result["transitions"]
    assert [h["n_workers"] for h in result["history"]] == [3, 2, 3]
    assert result["workers"] == 3


def test_serve_a_training_checkpoint_serves_eval_params(tmp_path):
    ckpt = tmp_path / "state.npz"
    trained = _train(tmp_path, "--steps", "2", "--workers", "2",
                     "--ckpt", str(ckpt))
    flags = ["--reduced", "--layers", "1", "--device", "cpu", "--seed", "3"]
    args = serve.build_argparser().parse_args(flags + ["--train-ckpt",
                                                       str(ckpt)])
    model, params, _ = serve.build(args)
    alg, _ = algorithm_for_checkpoint(ckpt)
    want = alg.eval_params(trained["state"])
    assert P.bitwise(params, want)
    # one-shot, greedy: the ids serving the in-memory eval_params gives
    ids = serve.main(flags + ["--train-ckpt", str(ckpt), "--batch", "2",
                              "--prompt-len", "6", "--gen", "3"])
    gen = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, model.cfg.vocab_size, (2, 6), generator=gen)
    assert torch.equal(ids, serve.generate(model, want, prompts, gen=3,
                                           generator=gen))
    # the paged scheduler through the kernel wrapper
    reqs = tmp_path / "r.jsonl"
    reqs.write_text('{"prompt_len": 5, "gen": 3}\n'
                    '{"prompt_len": 7, "gen": 2}\n')
    paged = flags + ["--requests", str(reqs), "--slots", "2", "--pages",
                     "8", "--page-size", "4", "--paged-kernel"]
    sch = serve.main(paged + ["--train-ckpt", str(ckpt)])
    mem = serve.run_scheduler(
        model, want, serve.load_requests(reqs, model.cfg.vocab_size, 16,
                                         seed=3),
        serve.build_argparser().parse_args(paged))
    assert {r.rid: r.out for r in sch.finished} == \
        {r.rid: r.out for r in mem.finished}
