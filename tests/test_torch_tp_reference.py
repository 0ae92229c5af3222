"""The port's (1, 2) tensor-parallel ranks against the reference's own
GSPMD step on a (1, 2) mesh of two forced host devices
(`tests/torch_tp_jax.reference_mesh`, one subprocess): its partition
rules split falcon-mamba's ``w_in`` into contiguous column blocks (the x
branch on rank 0, z on rank 1), recurrentgemma's RG-LRU width and
minicpm3's MLA heads, the three families with a layout trap.  Every leaf
of params, opt and the carried deltas within the parity tolerance
``TOL`` of its largest reference magnitude (a weight's update to one ulp
of the weight), the losses within ``RTOL_METRICS``.

The int8 wire over 'model': the reference scales each bucket row of
its global buckets; the port's ranks plan their buckets over their
local shards, sharded and whole leaves apart, so their rows take other
scales.  Run anyway (the port refuses it, naming ROADMAP item 6.7.6),
the (1, 2) int8 trajectory leaves most coordinates of the update off the
reference's, where the one-process int8 wire differs from the reference
by quantum flips at about ten coordinates a step (ROADMAP queue C)."""
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
# (the reference's hp overrides, the port's spec) of each compared run
RUNS = [(n, {}, FUSED) for n in NAMES] + [
    ("qwen3", INT8, {**FUSED, "cfg": INT8, "unrefused": True})]
# the coordinates of a 3-step update that quantum flips can move: about
# ten a step on the int8 wire (ROADMAP queue C), with room to spare
FLIPS = 300


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's rank-0 records, the reference's npz per run)."""
    tmp = tmp_path_factory.mktemp("ref")
    refs = [r for r, _ in TJ.reference_mesh([(n, hp) for n, hp, _ in RUNS],
                                            tmp)]
    runs = [(n, spec, 2) for n, _, spec in RUNS]
    res = MW.spawn(2, "tp", dict(shape=(1, 2), runs=runs,
                                 keep=tuple(range(len(runs))),
                                 weights={n: TJ.weights(n)
                                          for n, _, _ in RUNS}),
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


def test_int8_wire_over_model_leaves_the_reference(both):
    """The int8 (1, 2) run scales other buckets than the reference's
    GSPMD step, which is why the port refuses the quantized wires over
    'model' (tests/test_torch_tensor_parallel.py)."""
    runs, refs = both
    rec, ref = runs[-1], refs[-1]
    off = total = 0
    for x, y, _, is_param in TJ.moves(rec, ref, "qwen3"):
        if is_param:
            off += int((np.abs(x - y) > TOL * np.abs(y).max()).sum())
            total += x.size
    # most of the update, not a handful of flipped quanta
    assert off > FLIPS and off > total // 4, (off, total)
    # the port's own one-process int8 run is as far from the mesh's
    assert rec["diff"]["params"][0] > 100 * TOL, rec["diff"]
