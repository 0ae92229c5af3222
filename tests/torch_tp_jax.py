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
for i, (arch, algo, hp, nudge, reducer) in enumerate({runs}):
    cfg = reduced(get_config(arch))
    model = Model(cfg, remat=False)
    alg = registry.make(algo, DCS3GDConfig(**{{**{hp0}, **hp}}),
                        n_workers=2, buckets=2, reducer=reducer)
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
    tail), W = 2 at 2 buckets, 3 steps, for each ``(name, hp)``,
    ``(name, hp, algo, nudge)`` or ``(name, hp, algo, nudge, reducer)``
    of ``runs`` (hp: `DCS3GDConfig` overrides of `MW.HP`; algo: dc_s3gd
    and reducer: mean_allreduce by default), in one subprocess.
    Per run, the npz of its state leaves (params, opt, comm) and losses,
    and with ``nudge`` the npz of the same run from weights one ulp up
    and from weights one ulp down (else an empty list)."""
    runs = [(n, hp, *rest, *("dc_s3gd", False, "mean_allreduce")[len(rest):])
            for n, hp, *rest in runs]
    code = _REFERENCE_MESH.format(
        runs=repr([(_arch(n), algo, hp, nudge, reducer)
                   for n, hp, algo, nudge, reducer in runs]),
        hp0=repr(MW.HP),
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


_REFERENCE_SERVE_MESH = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.launch.engine import Engine, mesh_context
from repro.models.transformer import Model
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 2),
                         ("data", "model"))
assert len(jax.devices()) == 2
for i, (arch, cache_len, gen) in enumerate({runs}):
    cfg = reduced(get_config(arch))
    model = Model(cfg, remat=False)
    engine = Engine(model, mesh=mesh)
    params = model.init(jax.random.PRNGKey(0))
    batch = {{k: jnp.asarray(v) for k, v in
              np.load(f"{{sys.argv[1]}}/prompt{{i}}.npz").items()}}
    batch["tokens"] = batch["tokens"].astype(jnp.int32)
    B = batch["tokens"].shape[0]
    p_sh, b_sh, _ = engine.serve_shardings(params, batch=batch,
                                           global_batch=B)
    with mesh_context(mesh):
        logits, cache = jax.jit(
            lambda p, b: model.prefill(p, b, cache_len=cache_len),
            in_shardings=(p_sh, b_sh))(params, batch)
        step = {{"tokens": jnp.zeros((B, 1), jnp.int32),
                 "pos": jnp.int32(0)}}
        _, s_sh, c_sh = engine.serve_shardings(params, batch=step,
                                               cache=cache, global_batch=B)
        decode = jax.jit(lambda p, c, b: model.decode_step(p, c, b),
                         in_shardings=(p_sh, c_sh, s_sh),
                         out_shardings=(None, c_sh), donate_argnums=1)
        cache = jax.device_put(cache, c_sh)
        out, tok = [np.asarray(logits)], jnp.argmax(logits, -1)
        toks = [np.asarray(tok)]
        pos = batch["tokens"].shape[1]
        for t in range(gen - 1):
            logits, cache = decode(params, cache, {{
                "tokens": tok[:, None].astype(jnp.int32),
                "pos": jnp.int32(pos + t)}})
            tok = jnp.argmax(logits, -1)
            out.append(np.asarray(logits))
            toks.append(np.asarray(tok))
    np.savez(f"{{sys.argv[1]}}/serve{{i}}.npz", tokens=np.stack(toks, 1),
             **{{f"logits{{j}}": x for j, x in enumerate(out)}})
"""


class Pending:
    """A subprocess running while the caller does other work: `wait`
    returns ``read()`` once it has exited 0 (the same object on every
    call); `close` kills it if it still runs."""

    def __init__(self, proc, read):
        self.proc, self.read, self._res = proc, read, None

    def wait(self):
        if self._res is None:
            _, err = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0, err[-3000:]
            self._res = self.read()
        return self._res

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def reference_serve_mesh(runs, out: Path) -> Pending:
    """Start the reference's greedy one-shot loop with its
    ``model.prefill`` and ``model.decode_step`` jitted under its own
    ``serve_shardings`` (params by the partition rules, the batch's rows,
    the caches by ``cache_specs``) on a (1, 2) mesh of two forced host
    CPU devices, for each ``(name, prompt batch (numpy dict), cache_len,
    gen)`` of ``runs``, in one subprocess.  Its `Pending.wait` gives, per
    run, ``logits`` (the prefill's, then each decode step's (B,
    vocab_padded)) and the (B, gen) greedy ``tokens``."""
    for i, (_, batch, _, _) in enumerate(runs):
        np.savez(out / f"prompt{i}.npz", **batch)
    code = _REFERENCE_SERVE_MESH.format(
        runs=repr([(_arch(n), int(c), int(g)) for n, _, c, g in runs]))
    proc = subprocess.Popen([sys.executable, "-c", code, str(out)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True, cwd=out,
                            env={**os.environ,
                                 "PYTHONPATH": str(ROOT / "src"),
                                 "OMP_NUM_THREADS": "1"})

    def read() -> list:
        res = []
        for i, (_, _, _, gen) in enumerate(runs):
            f = np.load(out / f"serve{i}.npz")
            res.append({"logits": [f[f"logits{j}"] for j in range(gen)],
                        "tokens": f["tokens"]})
        return res
    return Pending(proc, read)
