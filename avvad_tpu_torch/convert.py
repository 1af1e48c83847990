"""JAX ``AVVAD`` / ``VideoVAD`` / ``AudioVAD`` / ``RawAudioVAD`` variables
-> the port's ``state_dict`` (trained ones too: ``batch_stats`` become the
BatchNorm running statistics).

The input is the Flax variables tree as nested dicts of numpy arrays
(``params``, ``batch_stats``, ``sketch`` and ``quant`` collections; the
sketches in plain (d_in, out) or folded (2, d_in, f) form). No Flax is imported: the
tree is walked as plain dicts. Rules, by leaf name:

- ``kernel`` 4-d (HWIO conv) -> ``weight`` OIHW; ``kernel`` 3-d (a Conv1D's
  (W, I, O), the WaveNet encoder's) -> ``Conv1d`` ``weight`` (O, I, W);
  ``kernel`` 2-d (Dense, (in, out)) -> ``weight`` (out, in);
- BatchNorm ``scale`` -> ``weight``, ``mean`` -> ``running_mean``, ``var`` ->
  ``running_var`` (plus ``num_batches_tracked``);
- LSTM ``w_ih`` / ``w_hh`` / ``bias``, Dense ``bias``, the sketches and the
  int8 tower's activation scales (``quant``: ``q_stem``, ``q1``, ``q_out``,
  and ``q_in`` of the int8 stem, 0-d buffers) keep their names and layouts.
The path through the tree becomes the dotted module path, which the port's
modules mirror.

``to_flax_variables`` is the inverse (``num_batches_tracked`` dropped), and
``adam_from_optax`` / ``adam_to_optax`` carry optax's Adam state
(``ScaleByAdamState(count, mu, nu)``, alone or inside
``multi_transform({"train": adam, "frozen": set_to_zero()})`` when the
video trunk is frozen) to ``torch.optim.Adam``'s (``step``, ``exp_avg``,
``exp_avg_sq`` a parameter) and back, for the Orbax checkpoints of the JAX
package (``train/checkpoint.py``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
# Flax ``kernel`` by rank -> the torch ``weight`` layout
_KERNEL_LAYOUT = {
    4: lambda k: k.transpose(3, 2, 0, 1),  # conv HWIO -> OIHW
    3: lambda k: k.transpose(2, 1, 0),  # Conv1D (W, I, O) -> (O, I, W)
    2: lambda k: k.T,  # Dense (in, out) -> (out, in)
}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def from_flax_variables(tree: Mapping) -> dict[str, torch.Tensor]:
    """-> state_dict for ``avvad_tpu_torch.models.AVVAD``, ``VideoVAD``,
    ``AudioVAD`` or ``RawAudioVAD`` (strict load)."""
    state: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats", "sketch", "quant"):
        for path, arr in _flatten(tree.get(collection, {})):
            *mods, leaf = path
            if leaf == "kernel":
                leaf = "weight"
                arr = _KERNEL_LAYOUT[arr.ndim](arr)
            else:
                leaf = _RENAME.get(leaf, leaf)
            key = ".".join([*mods, leaf])
            state[key] = torch.tensor(arr, dtype=torch.float32)
            if leaf == "running_mean":
                state[".".join([*mods, "num_batches_tracked"])] = \
                    torch.tensor(0, dtype=torch.long)
    return state


# the torch ``weight`` layout -> the Flax ``kernel``, by rank
_KERNEL_INVERSE = {
    4: lambda w: w.transpose(2, 3, 1, 0),  # OIHW -> conv HWIO
    3: lambda w: w.transpose(2, 1, 0),  # (O, I, W) -> Conv1D (W, I, O)
    2: lambda w: w.T,  # (out, in) -> Dense (in, out)
}
_STATS = {"running_mean": "mean", "running_var": "var"}
# the int8 tower's activation scales: the ``quant`` collection
QUANT_LEAVES = ("q_stem", "q1", "q_out", "q_in")


def flax_location(key: str, ndim: int, is_param: bool, keys) -> Optional[tuple]:
    """A port ``state_dict`` key -> (collection, path in it, whether the
    leaf is a ``kernel``), or None for ``num_batches_tracked``. ``keys``:
    the state dict's keys (a ``weight`` beside a ``running_mean`` is a
    BatchNorm ``scale``)."""
    *mods, leaf = key.split(".")
    if leaf == "num_batches_tracked":
        return None
    if leaf in _STATS:
        return "batch_stats", (*mods, _STATS[leaf]), False
    if leaf in QUANT_LEAVES:
        return "quant", (*mods, leaf), False
    if not is_param:
        return "sketch", (*mods, leaf), False
    if leaf == "weight":
        if ".".join([*mods, "running_mean"]) in keys:
            return "params", (*mods, "scale"), False
        if ndim not in _KERNEL_INVERSE:
            raise ValueError(f"{key}: a {ndim}-d weight has no Flax kernel layout")
        return "params", (*mods, "kernel"), True
    return "params", (*mods, leaf), False


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree, path: tuple):
    for k in path:
        if not isinstance(tree, Mapping) or k not in tree:
            raise KeyError("/".join(path))
        tree = tree[k]
    return tree


def to_flax_variables(state: Mapping[str, torch.Tensor], params) -> dict:
    """The port's ``state_dict`` -> Flax variables (``params``,
    ``batch_stats``, ``sketch``, ``quant``; nested dicts of numpy arrays),
    the inverse of ``from_flax_variables``. ``params``: the names in
    ``state`` that are parameters (the rest are buffers)."""
    params = set(params)
    out: dict = {}
    for key, value in state.items():
        arr = value.detach().cpu().numpy()
        loc = flax_location(key, arr.ndim, key in params, state)
        if loc is None:
            continue
        collection, path, kernel = loc
        if kernel:
            arr = _KERNEL_INVERSE[arr.ndim](arr)
        _put(out.setdefault(collection, {}), path, np.ascontiguousarray(arr))
    return out


def _find_adam(tree, where=()) -> list:
    """-> [(path, node)] of every ScaleByAdamState ({count, mu, nu}) node."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return [(where, tree)]
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return []
    return [hit for k, v in items for hit in _find_adam(v, where + (str(k),))]


def adam_from_optax(opt_state, groups: list, keys, template: dict) -> dict:
    """optax's Adam state (a restored ``opt_state`` tree) -> a
    ``torch.optim.Adam`` state dict. ``groups``: for each parameter group,
    its parameters in order as (state_dict key, shape); ``keys``: the
    model's state_dict keys; ``template``: the optimizer's own
    ``state_dict()``, whose ``param_groups`` (learning rate, betas) are
    kept. A parameter that the checkpoint's optimizer masked (frozen) and
    the port trains, or the other way round, raises."""
    found = _find_adam(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one optax Adam state (count, mu, nu) in opt_state, "
                         f"found {len(found)}")
    _, adam = found[0]
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    state: dict = {}
    trained = set()
    for index, (key, shape) in enumerate(p for group in groups for p in group):
        _, path, kernel = flax_location(key, len(shape), True, keys)
        moments = []
        for name in ("mu", "nu"):
            try:
                m = _get(adam[name], path)
            except KeyError:
                raise ValueError(f"{key}: no Adam {name} at {'/'.join(path)} in the "
                                 "checkpoint") from None
            if m is None:
                raise ValueError(f"{key}: the checkpoint's optimizer froze it (masked), "
                                 "the port's trains it")
            m = np.asarray(m)
            m = np.ascontiguousarray(_KERNEL_LAYOUT[m.ndim](m) if kernel else m)
            if m.shape != tuple(shape):
                raise ValueError(f"{key}: Adam {name} of shape {m.shape}, the parameter "
                                 f"is {tuple(shape)}")
            moments.append(torch.from_numpy(m).float())
        trained.add(path)
        state[index] = {"step": step.clone(), "exp_avg": moments[0],
                        "exp_avg_sq": moments[1]}
    extra = [path for path, m in _flatten_paths(adam["mu"])
             if m is not None and path not in trained]
    if extra:
        raise ValueError(f"the checkpoint holds Adam moments for {'/'.join(extra[0])} "
                         f"(and {len(extra) - 1} more), which the port does not train")
    return {"state": state, "param_groups": template["param_groups"]}


def _flatten_paths(tree, prefix: tuple = ()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten_paths(v, prefix + (str(k),))
    else:
        yield prefix, tree


def adam_to_optax(opt_sd: dict, groups: list, all_params: list, keys):
    """A ``torch.optim.Adam`` state dict -> optax's Adam ``opt_state`` as
    the JAX package's ``make_optimizer`` builds it: ``[ScaleByAdamState,
    EmptyState]`` (as dicts and lists, ``None`` for the empty state), or
    inside ``multi_transform`` (``inner_states`` "frozen" / "train", the
    frozen parameters' moments ``None``, optax's masked nodes) when some
    parameter of ``all_params`` is in no group. ``groups`` and ``keys`` as
    for ``adam_from_optax``; ``all_params``: every parameter of the model
    as (key, shape). A parameter with no Adam state (the optimizer has not
    stepped, or it never had a gradient) gets zero moments, as optax keeps
    for it; the count is the step of those that have one, else 0."""
    trained = [p for group in groups for p in group]
    names = {key for key, _ in trained}
    mu: dict = {}
    nu: dict = {}
    for key, shape in all_params:
        path = flax_location(key, len(shape), True, keys)[1]
        _put(mu, path, None)
        _put(nu, path, None)
    count = 0
    for index, (key, shape) in enumerate(trained):
        _, path, kernel = flax_location(key, len(shape), True, keys)
        st = opt_sd["state"].get(index)
        for tree, name in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            if st is None:
                arr = np.zeros(shape, np.float32)
            else:
                arr = st[name].detach().cpu().numpy()
            _put(tree, path, np.ascontiguousarray(_KERNEL_INVERSE[arr.ndim](arr)
                                                  if kernel else arr))
        if st is not None:
            count = max(count, int(st["step"]))
    adam = {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}
    if all(key in names for key, _ in all_params):
        return [adam, None]
    return {"inner_states": {"frozen": {"inner_state": None},
                             "train": {"inner_state": [adam, None]}}}
