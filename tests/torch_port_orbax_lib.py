"""Helpers of the Orbax checkpoint tests (tests/test_torch_port_orbax*.py):
JAX train states built from the port's weights, and the walk of restored
trees."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from avvad_tpu.train.state import TrainState as JTrainState
from avvad_tpu.train.state import make_optimizer as jmake_optimizer
from avvad_tpu.train.state import trainable_except_video_trunk as jfreeze

LR = 1e-4
# one optimizer object each, so that states built apart share their static
# fields (else JAX's step from a restored state compiles again)
TX = {False: jmake_optimizer(LR), True: jmake_optimizer(LR, freeze_filter=jfreeze)}


def params_of(model) -> set:
    """The names of ``model``'s parameters (``to_flax_variables``' ``params``)."""
    return {n for n, _ in model.named_parameters()}


def jax_state(jm, variables: dict, freeze: bool) -> JTrainState:
    """A JAX TrainState of ``jm`` over Flax ``variables``, Adam at optax's
    init (inside ``multi_transform`` with the trunk frozen), step 0."""
    tx = TX[freeze]
    return JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables.get("batch_stats"),
                       sketch=variables.get("sketch"), opt_state=tx.init(variables["params"]),
                       apply_fn=jm.apply, tx=tx, quant=variables.get("quant"))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves_with_paths(tree) -> dict:
    """A pytree's leaves by their "/"-joined key path."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def ours(tree, path: str):
    """The leaf at a "/"-joined path of nested dicts and lists."""
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def bits(a) -> np.ndarray:
    """An array's values as numpy, bfloat16 as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def adam_of(opt_state):
    """optax's ScaleByAdamState inside an opt_state (multi_transform too)."""
    return [v for v in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(v, "mu")][0]
