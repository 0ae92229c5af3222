"""The port's (1, 2) tensor-parallel ranks against the reference's own
GSPMD step on a (1, 2) mesh of two forced host devices
(`tests/torch_tp_jax.reference_mesh`, one subprocess): its partition
rules split falcon-mamba's ``w_in`` into contiguous column blocks (the x
branch on rank 0, z on rank 1), recurrentgemma's RG-LRU width and
minicpm3's MLA heads, the three families with a layout trap.  Every leaf
of params, opt and the carried deltas within the parity tolerance
``TOL`` of its largest reference magnitude (a weight's update to one ulp
of the weight), the losses within ``RTOL_METRICS``.

The compressed and quantized wires over 'model' (topk, topk_exact and
the int8 ``comm_dtype`` on the reduced qwen3): the reference selects and
scales over its global buckets, whose flat dim GSPMD replicates over
'model'; the port's ranks gather the same whole buckets before the
reduce (`repro_torch.parallel.tensor.WholeWire`).  Gathered sharded
gradients differ from one process's in their last bits, so a coordinate
at a threshold or a quantum boundary may flip: at most ``FLIPS`` of the
3-step update's coordinates lie more than ``TOL`` of their leaf's scale
off the reference's (the int8 wire left 2,050,650 of 2,886,656 there
while each rank scaled its own local buckets), the losses within
``RTOL_METRICS``."""
import jax
import numpy as np
import pytest

import torch_mesh_worker as MW
import torch_tp_jax as TJ
from torch_threads import one_torch_thread  # noqa: F401

TOL, RTOL_METRICS = 1e-4, 1e-5        # tests/test_torch_dc_s3gd.py's
FUSED = {"buckets": 2, "use_kernels": True}
NAMES = ("mamba", "rgemma", "minicpm")
INT8 = {"comm_dtype": "int8"}
# wire -> (the reference's hp overrides, its reducer, the port's spec)
WIRES = {"int8": (INT8, "mean_allreduce", {**FUSED, "cfg": INT8}),
         "topk": ({}, "topk", {**FUSED, "reducer": "topk"}),
         "topk_exact": ({}, "topk_exact", {**FUSED,
                                           "reducer": "topk_exact"})}
# (name, the reference's hp overrides, the port's spec, the reference's
# reducer) of each compared run
RUNS = [(n, {}, FUSED, "mean_allreduce") for n in NAMES] + [
    ("qwen3", hp, spec, red) for hp, red, spec in WIRES.values()]
# the coordinates of a 3-step update that flips at a threshold or a
# quantum boundary can move: about ten a step on the one-process int8
# wire (ROADMAP queue C), with room to spare
FLIPS = 300


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's rank-0 records, the reference's npz per run)."""
    tmp = tmp_path_factory.mktemp("ref")
    refs = [r for r, _ in TJ.reference_mesh(
        [(n, hp, "dc_s3gd", False, red) for n, hp, _, red in RUNS], tmp)]
    runs = [(n, spec, 2) for n, _, spec, _ in RUNS]
    res = MW.spawn(2, "tp", dict(shape=(1, 2), runs=runs,
                                 keep=tuple(range(len(runs))),
                                 weights={n: TJ.weights(n)
                                          for n, _, _, _ in RUNS}),
                   tmp, module="torch_tp_worker")
    return res[0]["runs"], refs


@pytest.mark.parametrize("name", NAMES)
def test_matches_the_reference_step_on_a_two_device_mesh(both, name):
    i = NAMES.index(name)
    runs, refs = both
    rec, ref = runs[i], refs[i]
    for j, (x, y, ulp, _) in enumerate(TJ.moves(rec, ref, name)):
        np.testing.assert_allclose(
            x, y, rtol=0, atol=max(TOL * float(np.abs(y).max()), ulp),
            err_msg=f"leaf {j}")
    np.testing.assert_allclose([h["loss"] for h in rec["hist"]],
                               ref["losses"], rtol=RTOL_METRICS)


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_wire_over_model_matches_the_reference_step(both, wire):
    """The (1, 2) run of each wire reduces the reference's whole buckets:
    its update within ``FLIPS`` flipped coordinates of the reference's
    GSPMD step, its losses within ``RTOL_METRICS``."""
    i = len(NAMES) + list(WIRES).index(wire)
    runs, refs = both
    rec, ref = runs[i], refs[i]
    off = total = 0
    for x, y, ulp, is_param in TJ.moves(rec, ref, "qwen3"):
        if is_param:
            off += int((np.abs(x - y) > max(TOL * np.abs(y).max(),
                                            ulp)).sum())
            total += x.size
    assert off <= FLIPS, (off, total)
    np.testing.assert_allclose([h["loss"] for h in rec["hist"]],
                               ref["losses"], rtol=RTOL_METRICS)
