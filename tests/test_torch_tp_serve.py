"""Serving over the mesh (`Engine(model, mesh=mesh)` without an
algorithm): `Model.prefill`, `Model.decode_step` and the one-shot
`Engine.generate` on gloo ranks spawned on the CPU
(`tests/torch_tp_serve_worker.py`, through `tests/torch_mesh_worker.spawn`:
one torch thread each, one group per mesh, every case inside it).  The
weights are the reference's init of each reduced config
(`tests/torch_tp_jax.weights`), through `repro_torch.interop`.

* Every arch of the reference (the ten reduced configs) over (1, 2), and
  qwen3 also over (2, 1) and (2, 2), against ``mesh=None`` on the same
  rank: the prefill's logits and every decode step's within ``TOL`` of
  their scale (the row-parallel products and the vocab gather add their
  shards in another order: the worst measured 1.7e-6, recurrentgemma);
  each rank's caches equal `Engine.shard` of the one-process caches
  under their cache specs within ``TOL``, in their shapes and bytes
  (`parallel.sharding.shard_bytes`), and gathered back
  (`parallel.sharding.gather_shards`) equal the whole one-process
  caches; 8 greedy tokens of the rank's loop and of `Engine.generate`
  (every rank returns the whole batch) equal one process's.
* The reference's own serving under GSPMD: its ``prefill`` and
  ``decode_step`` jitted with its ``serve_shardings`` on a (1, 2) mesh of
  two forced host devices (`tests/torch_tp_jax.reference_serve_mesh`),
  for qwen3, granite (one KV head: the KV cache by position), minicpm3
  (MLA: the latents by position) and falcon-mamba (the state by
  channel): the port's (1, 2) logits within ``TOL`` and the greedy
  tokens equal.
"""
import numpy as np
import pytest

import torch_mesh_worker as MW
import torch_tp_jax as TJ
import torch_tp_serve_worker as SW
import torch_tp_worker as TW
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
ALL = ("qwen3", "granite", "stablelm", "olmoe", "phi", "mamba", "rgemma",
       "minicpm", "whisper", "qwen2vl")
MESHES = {"1x2": ((1, 2), ALL), "2x1": ((2, 1), ("qwen3",)),
          "2x2": ((2, 2), ("qwen3",))}
CASES = [(m, n) for m, (_, names) in MESHES.items() for n in names]
IDS = [f"{m}-{n}" for m, n in CASES]
REFERENCE = ("qwen3", "granite", "minicpm", "mamba")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The reference's GSPMD greedy loop per `REFERENCE` arch, started in
    its subprocess (it runs while the ranks do)."""
    runs = [(n, SW.prompts(TW.config(n)), SW.cache_len(TW.config(n), 2),
             SW.GEN) for n in REFERENCE]
    pending = TJ.reference_serve_mesh(runs,
                                      tmp_path_factory.mktemp("refserve"))
    yield pending
    pending.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, started):
    """mesh name -> every rank's records, one spawn per mesh."""
    cache = {}

    def get(mesh):
        if mesh not in cache:
            shape, names = MESHES[mesh]
            cache[mesh] = MW.spawn(
                shape[0] * shape[1], "serve",
                dict(shape=shape, names=names,
                     weights={n: TJ.weights(n) for n in names}),
                tmp_path_factory.mktemp(f"serve{mesh}"),
                module="torch_tp_serve_worker")
        return cache[mesh]
    return get


@pytest.fixture(scope="module")
def reference(started):
    return dict(zip(REFERENCE, started.wait()))


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_logits_match_one_process(ranks, mesh, name):
    """The prefill's last-position logits and every decode step's."""
    for r in ranks(mesh):
        rec = r["archs"][name]
        assert rec["logits"] <= TOL, rec["logits"]
        assert rec["steps"] <= TOL, rec["steps"]


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_rank_caches_are_the_cache_specs_shard(ranks, mesh, name):
    """Each rank's prefill caches: the shapes and bytes `Engine.shard`
    cuts under the cache specs, within ``TOL`` of the one-process
    caches' shard, and gathered back the whole one-process caches."""
    for r in ranks(mesh):
        rec = r["archs"][name]
        assert rec["cache_shapes"]
        assert rec["cache_bytes"] == rec["shard_bytes"]
        assert rec["cache"] <= TOL and rec["whole"] <= TOL, rec


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_greedy_tokens_match_one_process(ranks, mesh, name):
    """8 greedy tokens: the rank's loop over its rows, and
    `Engine.generate`, which returns the whole batch on every rank."""
    res = ranks(mesh)
    for r in res:
        rec = r["archs"][name]
        assert rec["tokens"] and rec["generate"]
    assert len({str(r["archs"][name]["generate_tokens"]) for r in res}) == 1


@pytest.mark.parametrize("name", REFERENCE)
def test_logits_match_the_reference_gspmd_serve(ranks, reference, name):
    """The (1, 2) rank 0's prefill and decode logits against the
    reference's under its own serve shardings (the reduced vocabulary
    has no padded column)."""
    loop = ranks("1x2")[0]["archs"][name]["loop"]
    ref = reference[name]
    assert len(loop["logits"]) == len(ref["logits"]) == SW.GEN
    for t, (a, b) in enumerate(zip(loop["logits"], ref["logits"])):
        np.testing.assert_allclose(
            a, b, rtol=0, atol=TOL * float(np.abs(b).max()),
            err_msg=f"step {t}")


@pytest.mark.parametrize("name", REFERENCE)
def test_greedy_tokens_match_the_reference_gspmd_serve(ranks, reference,
                                                       name):
    np.testing.assert_array_equal(
        ranks("1x2")[0]["archs"][name]["loop"]["tokens"],
        reference[name]["tokens"])
