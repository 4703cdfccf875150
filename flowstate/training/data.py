"""On-device data pipeline for flow training.

Equivalent of the reference ``get_dataloader``
(``hybrid_NF_MCMC/utils.py:49-59``): flatten configs -> float32 -> device.
There is no host-side DataLoader; an epoch is a device-side permutation and
a reshape to (num_batches, batch, dim), so the whole epoch trains inside one
jitted scan without host round-trips.

Also covers the NPZ trainer's dedup + subsample preprocessing
(``NF/Normalizing_flow_npz_data.py:41-59``).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def flatten_configs(configs: np.ndarray, num_particles: int,
                    num_dim: int) -> np.ndarray:
    """(M, N, d) or (M, N*d) -> (M, N*d) float32."""
    arr = np.asarray(configs, dtype=np.float32)
    return arr.reshape(arr.shape[0], num_particles * num_dim)


def dedup_subsample(data: np.ndarray, max_samples: Optional[int] = None,
                    seed: int = 0) -> np.ndarray:
    """Unique rows then optional uniform subsample; ref npz trainer :41-59."""
    unique = np.unique(data, axis=0)
    if max_samples is not None and len(unique) > max_samples:
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(unique), size=max_samples, replace=False)
        unique = unique[idx]
    return unique


def epoch_batches(key: jax.Array, data: jnp.ndarray,
                  batch_size: int) -> jnp.ndarray:
    """Shuffle and reshape to (num_batches, batch_size, dim).

    The remainder (< batch_size samples) is dropped to keep shapes static
    under jit (documented deviation from torch DataLoader's ragged last
    batch; at the reference's scales the split is exact, e.g.
    102400 / 512 = 200).
    """
    m = data.shape[0]
    num_batches = m // batch_size
    perm = jax.random.permutation(key, m)[: num_batches * batch_size]
    return data[perm].reshape(num_batches, batch_size, data.shape[-1])


def sliding_window_update(train_set: np.ndarray, new_samples: np.ndarray,
                          cumulative: bool,
                          window_size: Optional[int] = None) -> np.ndarray:
    """Algorithm-2 training-set policy (main_algorithm_2.py:421-432).

    cumulative=True: append everything; else keep only the newest window
    (defaults to the size of the incoming batch, i.e. fresh samples only).
    """
    if cumulative:
        return np.concatenate([train_set, new_samples], axis=0)
    if window_size is None:
        return np.asarray(new_samples)
    merged = np.concatenate([train_set, new_samples], axis=0)
    return merged[-window_size:]
