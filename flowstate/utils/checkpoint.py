"""Checkpoint / resume: the full experiment state, not just flow weights.

The reference only saves flow weights at the end of training
(``main_algorithm_1.py:326-327``, ``main_algorithm_2.py:468-471``) and never
checkpoints MCMC state — there is no resume story (SURVEY.md §5).  Here a
checkpoint captures everything needed for bit-exact continuation:

  {flow params, optimizer state, chain state (positions, energies,
   displacement adaption, counters, PRNG keys), cycle index, config snapshot}

The array tree is stored as one numpy ``tree.npz`` of its flattened leaves
(PRNG keys as their raw key data); the structure comes back from the
caller's ``example_tree``.  Small metadata rides along as JSON.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np


def _is_key(x) -> bool:
    return (isinstance(x, jax.Array)
            and jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key))


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    """Save a pytree checkpoint at ``directory/step_<step>``."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    leaves = jax.tree_util.tree_leaves(tree)
    np.savez(os.path.join(path, "tree.npz"), **{
        f"leaf_{i:05d}": np.asarray(
            jax.random.key_data(x) if _is_key(x) else x)
        for i, x in enumerate(leaves)})
    if metadata is not None:
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2)
    return path


def latest_checkpoint(directory: str) -> Optional[Tuple[int, str]]:
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append((int(name[5:]), os.path.join(directory, name)))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_checkpoint(path: str, example_tree: Any
                       ) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """Restore a pytree saved by ``save_checkpoint``.

    ``example_tree`` provides the structure, and says which leaves are
    PRNG keys (and of which implementation).
    """
    example, treedef = jax.tree_util.tree_flatten(example_tree)
    with np.load(os.path.join(path, "tree.npz")) as npz:
        stored = [npz[f"leaf_{i:05d}"] for i in range(len(npz.files))]
    if len(stored) != len(example):
        raise ValueError(f"checkpoint {path} holds {len(stored)} leaves, "
                         f"the example tree {len(example)}")
    leaves = [jax.random.wrap_key_data(a, impl=jax.random.key_impl(ex))
              if _is_key(ex) else a for a, ex in zip(stored, example)]
    tree = jax.tree_util.tree_unflatten(treedef, leaves)
    meta_path = os.path.join(path, "metadata.json")
    metadata = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return tree, metadata
