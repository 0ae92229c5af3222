"""The port's training entry point on the CPU: reduced qwen3-0.6b for two
steps gives finite metrics, the synthetic data is bitwise the
reference's, and an entry point asked for the card raises where there is
none."""
import math

import numpy as np
import pytest
import torch

from repro.data import SyntheticLMDataset as JData
from repro_torch.data.pipeline import SyntheticLMDataset, worker_batches
from repro_torch.launch import train
from torch_threads import one_torch_thread  # noqa: F401


def _args(*extra):
    return train.build_argparser().parse_args(
        ["--reduced", "--steps", "2", "--workers", "2",
         "--batch-per-worker", "2", "--seq", "16", "--log-every", "1",
         *extra])


@pytest.mark.parametrize("extra", [(), ("--buckets", "2", "--use-kernels"),
                                   ("--algo", "stale", "--comm-dtype",
                                    "bfloat16"),
                                   ("--reducer", "topk", "--buckets", "2",
                                    "--use-kernels"),
                                   ("--comm-dtype", "int8"),
                                   ("--local-optimizer", "nesterov"),
                                   ("--local-optimizer", "adam",
                                    "--buckets", "2"),
                                   ("--reducer", "gossip",
                                    "--gossip-neighbors", "1",
                                    "--buckets", "2", "--use-kernels"),
                                   ("--reducer", "hierarchical"),
                                   ("--staleness", "dynamic_ssp",
                                    "--ssp-threshold", "2",
                                    "--measure-skew", "--skew-warmup", "1")])
def test_run_on_cpu_gives_finite_metrics(extra, tmp_path):
    out = tmp_path / "metrics.json"
    result = train.run(_args(*extra, "--metrics-out", str(out)),
                       device="cpu")
    assert [h["step"] for h in result["history"]] == [0, 1]
    for h in result["history"]:
        for k in ("loss", "lr", "wd", "lambda", "distance_norm",
                  "delta_norm"):
            assert math.isfinite(h[k]), (k, h)
    assert result["state"].step == 2
    assert out.exists() and "state" not in out.read_text()


@pytest.mark.parametrize("reducer", ["topk_exact", "randk", "powersgd"])
def test_ssgd_with_a_compressed_reducer_runs_on_cpu(reducer):
    result = train.run(_args("--algo", "ssgd", "--reducer", reducer,
                             "--buckets", "2", "--use-kernels",
                             "--comm-dtype", "fp8"), device="cpu")
    for h in result["history"]:
        assert math.isfinite(h["loss"]) and "lambda" not in h
    assert result["state"].comm["reducer"]["residual"][0].any()


def test_new_flags_reach_the_algorithm():
    """--local-optimizer / --staleness / --ssp-threshold / --gossip-neighbors
    build the pieces they name; --measure-skew adds the measured skew to
    the history (0 in the one-process lockstep) and dynamic SSP admits
    every step."""
    result = train.run(_args("--local-optimizer", "lars", "--staleness",
                             "dynamic_ssp", "--ssp-threshold", "3",
                             "--measure-skew", "--reducer", "gossip",
                             "--gossip-neighbors", "2", "--workers", "4"),
                       device="cpu")
    assert [h["ssp_admit"] for h in result["history"]] == [1.0, 1.0]
    assert [h["measured_skew"] for h in result["history"]] == [0, 0]
    assert result["state"].comm["staleness"]["worker_steps"].tolist() \
        == [1] * 4
    args = _args("--local-optimizer", "lars", "--staleness", "dynamic_ssp",
                 "--ssp-threshold", "3", "--reducer", "gossip",
                 "--gossip-neighbors", "2")
    _, alg, _, _ = train.build(args, device="cpu")
    assert alg.local_optimizer.name == "lars"
    assert alg.staleness.name == "dynamic_ssp" and alg.staleness.threshold \
        == 3
    assert alg.reducer.name == "gossip" and alg.reducer.neighbors == 2


def test_dc_asgd_runs_on_cpu():
    result = train.run(_args("--algo", "dc_asgd", "--local-optimizer",
                             "adam"), device="cpu")
    for h in result["history"]:
        assert math.isfinite(h["loss"]) and math.isfinite(
            h["staleness_dist"])
    assert result["state"].step == 2
    assert result["state"].comm["worker_params"]


def test_entry_point_without_a_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(_args())


def test_synthetic_tokens_are_bitwise_the_reference():
    ours = SyntheticLMDataset(512, 24, seed=3)
    theirs = JData(512, 24, seed=3)
    for step, worker in ((0, 0), (5, 1)):
        a, b = ours.batch(step, worker, 3), theirs.batch(step, worker, 3)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    stacked = worker_batches(ours, 2, 3, 2, device="cpu")
    assert stacked["tokens"].shape == (3, 2, 24)
    assert stacked["tokens"].dtype == torch.int32
