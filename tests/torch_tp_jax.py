"""The JAX package's side of the tensor-parallel tests (not a test file):
the reduced configs' weights, the reference's ``mesh=None`` trajectory
and its own GSPMD step on a ('data', 'model') mesh of forced host
devices, in a subprocess.  `tests/test_torch_tp_families.py` and
`tests/test_torch_tp_pieces.py` hold the port's spawned ranks
(`tests/torch_tp_worker.py`) against them."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import registry as j_registry
from repro.core.types import DCS3GDConfig as JConfig
from repro.data import SyntheticLMDataset as JData
from repro.data import worker_batches as j_worker_batches
from repro.models.transformer import Model as JModel

import torch_mesh_worker as MW
import torch_tp_worker as TW

ROOT = Path(__file__).resolve().parents[1]
METRICS = ("loss", "lambda", "distance_norm", "delta_norm")


def _arch(name: str) -> str:
    return TW.ARCHS[name.partition("_")[0]]


@functools.lru_cache(maxsize=None)
def weights(name: str):
    """The reference's init of the reduced config, seed 0, as numpy."""
    cfg = j_reduced(j_get_config(_arch(name)))
    return jax.tree.map(np.asarray,
                        JModel(cfg, remat=False).init(jax.random.PRNGKey(0)))


def jax_run(name: str, W: int, hp=None):
    """The reference's ``mesh=None`` dc_s3gd trajectory of ``name`` (its
    unfused bucketed tail: the same arithmetic as the port's fused one,
    whose Pallas kernels in interpret mode cost 4x the jit time here),
    on the port's batches (`TW.batches`: tokens and extras)."""
    cfg = j_reduced(j_get_config(_arch(name)))
    model = JModel(cfg, remat=False, moe_dense=name.endswith("_dense"))
    alg = j_registry.make("dc_s3gd", JConfig(**{**MW.HP, **(hp or {})}),
                          n_workers=W, buckets=2, use_kernels=False)
    step = jax.jit(functools.partial(alg.step, loss_fn=model.loss))
    state = alg.init(jax.tree.map(jnp.asarray, weights(name)))
    data = JData(cfg.vocab_size, MW.SEQ, seed=0)
    tcfg = TW.config(name)
    hist = []
    for t in range(MW.STEPS):
        batch = dict(j_worker_batches(data, t, W, MW.BPW))
        batch.update({k: jnp.asarray(v)
                      for k, v in TW.extras(tcfg, t, W).items()})
        state, m = step(state, batch)
        hist.append({k: float(m[k]) for k in METRICS})
    return jax.tree.map(np.asarray, state), hist


_REFERENCE_MESH = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.core import registry
from repro.core.types import DCS3GDConfig
from repro.data import SyntheticLMDataset, worker_batches
from repro.launch.engine import Engine
from repro.models.transformer import Model
# the classic constructor: GSPMD's automatic axes (jax.make_mesh's default
# axis types are explicit in this jax, which its vmap refuses here)
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 2),
                         ("data", "model"))
assert len(jax.devices()) == 2
for i, (arch, algo, hp, nudge) in enumerate({runs}):
    cfg = reduced(get_config(arch))
    model = Model(cfg, remat=False)
    alg = registry.make(algo, DCS3GDConfig(**{{**{hp0}, **hp}}),
                        n_workers=2, buckets=2)
    engine = Engine(model, alg, mesh=mesh)
    params = model.init(jax.random.PRNGKey(0))
    data = SyntheticLMDataset(cfg.vocab_size, {seq}, seed=0)
    batch = worker_batches(data, 0, 2, {bpw})
    step = engine.jit_train_step(alg.init(params), batch, donate=False)
    starts = [("", params)] + ([(tag, jax.tree.map(
        lambda x, to=to: jnp.nextafter(x, jnp.float32(to)), params))
        for tag, to in (("up", jnp.inf), ("down", -jnp.inf))]
        if nudge else [])
    for tag, w0 in starts:
        state = alg.init(w0)
        losses = []
        for t in range({steps}):
            state, m = step(state, worker_batches(data, t, 2, {bpw}))
            losses.append(float(m["loss"]))
        leaves = jax.tree.leaves(state.params) \\
            + jax.tree.leaves(state.opt) + jax.tree.leaves(state.comm)
        np.savez(f"{{sys.argv[1]}}/ref{{i}}{{tag}}.npz",
                 losses=np.asarray(losses),
                 **{{f"l{{j}}": np.asarray(x) for j, x in enumerate(leaves)}})
"""


def reference_mesh(runs, out: Path) -> list:
    """The reference's own step on a (1, 2) mesh of two forced host CPU
    devices (its partition rules, its GSPMD collectives, its unfused
    tail), W = 2 at 2 buckets, 3 steps, for each ``(name, hp)`` or
    ``(name, hp, algo, nudge)`` of ``runs`` (hp: `DCS3GDConfig`
    overrides of `MW.HP`; algo: dc_s3gd by default), in one subprocess.
    Per run, the npz of its state leaves (params, opt, comm) and losses,
    and with ``nudge`` the npz of the same run from weights one ulp up
    and from weights one ulp down (else an empty list)."""
    runs = [(n, hp, *rest) if rest else (n, hp, "dc_s3gd", False)
            for n, hp, *rest in runs]
    code = _REFERENCE_MESH.format(
        runs=repr([(_arch(n), algo, hp, nudge)
                   for n, hp, algo, nudge in runs]), hp0=repr(MW.HP),
        seq=MW.SEQ, bpw=MW.BPW, steps=MW.STEPS)
    r = subprocess.run([sys.executable, "-c", code, str(out)],
                       capture_output=True, text=True, timeout=900,
                       cwd=out, env={**os.environ,
                                     "PYTHONPATH": str(ROOT / "src"),
                                     "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    return [(np.load(out / f"ref{i}.npz"),
             [np.load(out / f"ref{i}{way}.npz") for way in ("up", "down")]
             if run[3] else [])
            for i, run in enumerate(runs)]


def moves(rec, ref, name):
    """Per leaf (params, opt, comm in the reference's order): the port's
    and the reference's values (the weights' moves for params), the
    one-ulp allowance of each weight, and whether it is a param."""
    mine = state_leaves(rec["state"])
    assert len(ref.files) == len(mine) + 1
    base = jax.tree.leaves(weights(name))
    out = []
    for j, x in enumerate(mine):
        x, y = np.asarray(x, np.float64), ref[f"l{j}"].astype(np.float64)
        ulp = 0.0
        if j < len(base):
            x, y = x - base[j], y - base[j]
            ulp = float(np.spacing(np.abs(base[j]).max()))
        out.append((x, y, ulp, j < len(base)))
    return out


def state_leaves(state: dict) -> list:
    """A gathered state's leaves in the reference's order: params, opt,
    comm."""
    return jax.tree.leaves(state["params"]) + jax.tree.leaves(
        state["opt"]) + jax.tree.leaves(state["comm"])


def assert_close(a, b, tol, what, base=None):
    """Leaf by leaf, within ``tol`` of each ``b`` leaf's largest
    magnitude (of its move from ``base``, where given)."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    base = [0.0] * len(la) if base is None else jax.tree.leaves(base)
    assert len(la) == len(lb), what
    for x, y, z in zip(la, lb, base):
        x, y = np.asarray(x, np.float64) - z, np.asarray(y, np.float64) - z
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=tol * float(np.abs(y).max()),
                                   err_msg=what)
