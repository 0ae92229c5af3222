"""Checkpoints: a state tree <-> one ``.npz`` file (the port of
``repro.checkpoint.store``, in the reference's own format, so files cross
both ways).

The file holds ``leaf_{i}`` arrays and ``__meta__``, a JSON string with
``names`` (each leaf's path as JAX's ``keystr`` spells it:
``.params['b']['c']``, ``.comm['delta_prev'][0]``, ``.step``), ``dtypes``
(numpy names; ``"bfloat16"`` for bf16), ``step`` and the writer's extra
metadata.  Dict keys go in sorted order, as `repro_torch.tree` flattens.

* bfloat16 has no numpy dtype: a bf16 leaf is written as its 16-bit
  pattern viewed as ``V2``, the bytes the reference's ``ml_dtypes`` arrays
  land as, and read back through the ``dtypes`` entry.
* The port keeps some counters on the host (`TrainState.step`, randk's
  ``step``, dynamic SSP's numpy counters): they are written as the
  reference's int32 arrays and restored into the template's own type.
* Leaves restore onto the template leaf's device.

Leaves are copied to the host one at a time, so writing holds one leaf in
host memory at once.
"""
from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T

Tree = Any

def _named_leaves(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in `repro_torch.tree`'s flatten order:
    sorted dict keys, list and tuple positions, named-tuple fields
    spelled as attributes."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _named_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for f in tree._fields
                for item in _named_leaves(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in _named_leaves(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _dtype_name(leaf) -> str:
    """The numpy dtype name a leaf is written under (``bfloat16`` for
    bf16, as the reference's ``ml_dtypes`` arrays name it)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, int):
        return "int32"   # the reference's counters are int32 arrays
    return np.asarray(leaf).dtype.name


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array the file stores."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf, np.dtype(_dtype_name(leaf)))


def _from_host(a: np.ndarray, name: str, like) -> Any:
    """A stored array (dtype ``name``) as a leaf of ``like``'s kind."""
    if isinstance(like, torch.Tensor):
        if name == "bfloat16":
            t = torch.from_numpy(np.array(a).view(np.int16)) \
                .view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, np.dtype(name)))
        return t.to(like.device)
    if isinstance(like, int):
        return int(a)
    return np.array(a, np.dtype(name))


def _cast(leaf, like) -> Any:
    """``leaf`` in ``like``'s dtype (``cast_dtypes=True``)."""
    if isinstance(like, torch.Tensor):
        return leaf.to(like.dtype)
    if isinstance(like, np.ndarray):
        return leaf.astype(like.dtype)
    return leaf


def save_pytree(path: str | Path, tree: Tree, *, step: Optional[int] = None,
                extra_meta: Optional[dict] = None) -> Path:
    """Write ``tree`` to ``path`` (``.npz`` appended where missing, as
    ``np.savez`` does); returns the path written."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    named = _named_leaves(tree)
    meta = {"names": [n for n, _ in named],
            "dtypes": [_dtype_name(x) for _, x in named],
            "step": step, **(extra_meta or {})}
    # np.savez's layout: one stored (uncompressed) .npy member per array
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        members = [("__meta__", lambda: np.asarray(json.dumps(meta)))] + [
            (f"leaf_{i}", lambda x=x: _to_host(x))
            for i, (_, x) in enumerate(named)]
        for name, array in members:
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, array(), allow_pickle=False)
    return path


def restore_pytree(path: str | Path, like: Tree, *,
                   cast_dtypes: bool = False) -> Tree:
    """Restore into the structure of ``like`` (names must match).

    Shapes and dtypes are checked against the template: a mismatch raises,
    and a mismatch only in the leading (worker) dim names the elastic
    resume as the cure.  ``cast_dtypes=True`` casts every restored leaf to
    the template's dtype instead of raising (a deliberate precision
    change)."""
    with np.load(_resolve(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        named = _named_leaves(like)
        names = [n for n, _ in named]
        if names != meta["names"]:
            missing = set(meta["names"]) ^ set(names)
            raise ValueError(f"checkpoint structure mismatch: "
                             f"{sorted(missing)[:5]}")
        shapes = [_stored_shape(data, f"leaf_{i}")
                  for i in range(len(names))]
        dtypes = meta["dtypes"]
        bad = [(n, s, _shape(x))
               for (n, x), s in zip(named, shapes) if s != _shape(x)]
        if bad:
            hint = ""
            # mismatches confined to the leading (worker) dim are a
            # worker-count change, not corruption: name the elastic resume
            lead_only = all(len(c) == len(t) and c[0] != t[0]
                            and c[1:] == t[1:] for _, c, t in bad if c and t)
            if lead_only and meta.get("n_workers") is not None:
                hint = (f" — every mismatch is leading-dim only and the "
                        f"checkpoint records n_workers={meta['n_workers']}: "
                        f"this looks like a worker-count change. Restore "
                        f"at the checkpoint's count and reshard via the "
                        f"elastic resize (train --resume --workers N, or "
                        f"alg.resize_state)")
            raise ValueError(f"checkpoint shape mismatch (ckpt vs "
                             f"template): {bad[:5]}{hint}")
        bad_dt = [(n, d, _dtype_name(x))
                  for (n, x), d in zip(named, dtypes) if d != _dtype_name(x)]
        if bad_dt and not cast_dtypes:
            raise ValueError(f"checkpoint dtype mismatch (ckpt vs "
                             f"template): {bad_dt[:5]} — pass "
                             f"cast_dtypes=True for a deliberate precision "
                             f"change")
        # one leaf in host memory at a time
        leaves = []
        for i, ((_, x), d) in enumerate(zip(named, dtypes)):
            leaf = _from_host(data[f"leaf_{i}"], d, x)
            leaves.append(_cast(leaf, x) if d != _dtype_name(x) else leaf)
    return T.unflatten(T.flatten(like)[1], leaves)


def _stored_shape(data, name: str) -> Tuple[int, ...]:
    """A stored array's shape, from its .npy header alone."""
    with data.zip.open(name + ".npy") as f:
        major, _ = np.lib.format.read_magic(f)
        read = np.lib.format.read_array_header_1_0 if major == 1 \
            else np.lib.format.read_array_header_2_0
        return tuple(read(f)[0])


def _resolve(path: str | Path) -> Path:
    path = Path(path)
    if not path.exists() and path.with_suffix(path.suffix + ".npz").exists():
        path = path.with_suffix(path.suffix + ".npz")
    return path


def checkpoint_exists(path: str | Path) -> bool:
    """Whether a checkpoint is present at ``path`` (the suffix rule of
    `restore_pytree`)."""
    return _resolve(path).exists()


def checkpoint_meta(path: str | Path) -> dict:
    """The metadata saved beside the state: ``step`` and the writer's extra
    keys (the Engine records the algorithm that trained it)."""
    with np.load(_resolve(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
    meta.pop("names", None)
    meta.pop("dtypes", None)
    return meta


def checkpoint_step(path: str | Path) -> Optional[int]:
    return checkpoint_meta(path).get("step")
