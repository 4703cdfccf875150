"""Monotone rational-quadratic spline transforms (Durkan et al., NSF).

Branchless re-implementation of the reference's
``NF/normflows/utils/splines.py``:

* ``rational_quadratic_spline``                — ``splines.py:91-222``
* ``unconstrained_rational_quadratic_spline``  — ``splines.py:16-88`` with
  ``linear`` tails, ``circular`` tails (last derivative tied to the first,
  ``splines.py:35-39``), and mixed per-dimension tails (``splines.py:40-47``).

Design notes for XLA:

* No boolean indexing / in-place mutation: out-of-interval elements are
  computed with inputs clamped into the interval and then selected away with
  ``jnp.where`` — the whole transform is one fused elementwise expression that is
  trivially ``vmap``-able and differentiable.
* Bin search is the reference's comparison-sum (``splines.py:11-13``),
  which lowers to a dense compare+reduce — cheap for the small bin
  counts used here (15-32) and vmap-friendly, unlike gather-heavy
  ``searchsorted`` paths.
* The inverse solves the quadratic with ``disc = |b^2 - 4ac|`` exactly as the
  reference does (``splines.py:171-186``) — the abs() plus the monotone
  parameterization keeps the root real; there is no data-dependent error
  branch under jit (NaN guards are the caller's job via loss skipping).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3

# softplus^{-1}(1 - min_derivative): the unnormalized-derivative value that
# makes the post-softplus derivative exactly 1 (identity init / linear tails).
# Reference: ``splines.py:30`` and ``wrapper.py:184``.
IDENTITY_DERIVATIVE_CONSTANT = float(np.log(np.expm1(1.0 - DEFAULT_MIN_DERIVATIVE)))

Tails = Union[str, Sequence[str]]


def _searchsorted(bin_locations: jnp.ndarray, inputs: jnp.ndarray,
                  eps: float = 1e-6) -> jnp.ndarray:
    """Locate the bin of each input; reference ``splines.py:11-13``.

    The reference's in-place ``bins[-1] += eps`` becomes an elementwise add
    of a static one-hot, which fuses with its neighbours.
    """
    num_bins = bin_locations.shape[-1] - 1
    last = (np.arange(num_bins + 1) == num_bins) * eps
    bins = bin_locations + jnp.asarray(last, dtype=bin_locations.dtype)
    idx = jnp.sum(inputs[..., None] >= bins, axis=-1) - 1
    return jnp.clip(idx, 0, num_bins - 1)


def _knots(unnormalized: jnp.ndarray, min_size: float, left, right):
    """Softmax bin sizes -> cumulative knot positions on [left, right].

    Reference ``splines.py:117-127``: softmax, floor at ``min_size``, cumsum,
    endpoints pinned exactly to the interval bounds.
    """
    num_bins = unnormalized.shape[-1]
    sizes = jax.nn.softmax(unnormalized, axis=-1)
    sizes = min_size + (1.0 - min_size * num_bins) * sizes
    cum = jnp.cumsum(sizes, axis=-1)
    cum = jnp.concatenate([jnp.zeros_like(cum[..., :1]), cum], axis=-1)
    cum = (right - left) * cum + left
    # Pin endpoints exactly (the reference overwrites them in place).
    cum = jnp.concatenate(
        [jnp.broadcast_to(left, cum[..., :1].shape).astype(cum.dtype),
         cum[..., 1:-1],
         jnp.broadcast_to(right, cum[..., -1:].shape).astype(cum.dtype)],
        axis=-1)
    sizes = cum[..., 1:] - cum[..., :-1]
    return cum, sizes


def rational_quadratic_spline(
    inputs: jnp.ndarray,
    unnormalized_widths: jnp.ndarray,
    unnormalized_heights: jnp.ndarray,
    unnormalized_derivatives: jnp.ndarray,
    inverse: bool = False,
    left=0.0,
    right=1.0,
    bottom=0.0,
    top=1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Monotone RQ spline on an interval; reference ``splines.py:91-222``.

    Args:
      inputs: (...,) values inside the interval.
      unnormalized_widths/heights: (..., num_bins).
      unnormalized_derivatives: (..., num_bins + 1).
      left/right/bottom/top: interval bounds (scalars or broadcastable arrays).

    Returns:
      (outputs, logabsdet) with shapes matching ``inputs``.
    """
    num_bins = unnormalized_widths.shape[-1]
    if min_bin_width * num_bins > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * num_bins > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")

    left = jnp.asarray(left, dtype=inputs.dtype)
    right = jnp.asarray(right, dtype=inputs.dtype)
    bottom = jnp.asarray(bottom, dtype=inputs.dtype)
    top = jnp.asarray(top, dtype=inputs.dtype)
    if left.ndim:  # per-element bounds need a trailing knot axis
        left, right = left[..., None], right[..., None]
        bottom, top = bottom[..., None], top[..., None]

    cumwidths, widths = _knots(unnormalized_widths, min_bin_width, left, right)
    cumheights, heights = _knots(unnormalized_heights, min_bin_height, bottom, top)
    derivatives = min_derivative + jax.nn.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)

    # ONE one-hot bin mask shared by all seven per-bin parameter selects.
    # Multiply+reduce against a shared one-hot is an elementwise expression
    # that fuses, and is bit-exact (summing zeros); whether
    # ``take_along_axis`` is cheaper on the GPU is ROADMAP S3.
    onehot = (bin_idx[..., None]
              == jnp.arange(num_bins, dtype=bin_idx.dtype)
              ).astype(inputs.dtype)

    def take(arr):
        return jnp.sum(arr * onehot, axis=-1)

    input_cumwidths = take(cumwidths[..., :-1])
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights[..., :-1])
    delta = heights / widths
    input_delta = take(delta)
    input_derivatives = take(derivatives[..., :-1])
    input_derivatives_plus_one = take(derivatives[..., 1:])
    input_heights = take(heights)

    d_sum = input_derivatives + input_derivatives_plus_one - 2.0 * input_delta

    if inverse:
        a = (inputs - input_cumheights) * d_sum + input_heights * (
            input_delta - input_derivatives)
        b = input_heights * input_derivatives - (inputs - input_cumheights) * d_sum
        c = -input_delta * (inputs - input_cumheights)
        # |.| guard exactly as the reference (splines.py:171); the monotone
        # parameterization keeps the true discriminant >= 0.
        discriminant = jnp.abs(b * b - 4.0 * a * c)
        root = (2.0 * c) / (-b - jnp.sqrt(discriminant))
        outputs = root * input_bin_widths + input_cumwidths

        theta_one_minus_theta = root * (1.0 - root)
        denominator = input_delta + d_sum * theta_one_minus_theta
        derivative_numerator = input_delta**2 * (
            input_derivatives_plus_one * root**2
            + 2.0 * input_delta * theta_one_minus_theta
            + input_derivatives * (1.0 - root) ** 2)
        logabsdet = jnp.log(derivative_numerator) - 2.0 * jnp.log(denominator)
        return outputs, -logabsdet
    else:
        theta = (inputs - input_cumwidths) / input_bin_widths
        theta_one_minus_theta = theta * (1.0 - theta)
        numerator = input_heights * (
            input_delta * theta**2 + input_derivatives * theta_one_minus_theta)
        denominator = input_delta + d_sum * theta_one_minus_theta
        outputs = input_cumheights + numerator / denominator
        derivative_numerator = input_delta**2 * (
            input_derivatives_plus_one * theta**2
            + 2.0 * input_delta * theta_one_minus_theta
            + input_derivatives * (1.0 - theta) ** 2)
        logabsdet = jnp.log(derivative_numerator) - 2.0 * jnp.log(denominator)
        return outputs, logabsdet


def _pad_derivatives(unnormalized_derivatives: jnp.ndarray,
                     tails: Tails, circular_tie: bool = True) -> jnp.ndarray:
    """Apply the tail rule to the derivative parameters.

    Reference ``splines.py:28-47``:
    * "linear":   pad both ends with softplus^{-1}(1 - min_d)  (identity slope)
    * "circular": pad one slot, tie last derivative to the first
    * per-dim list: (num_bins+1) slots supplied; linear dims get both ends
      overwritten with the constant, circular dims get last := first.

    ``circular_tie``: the reference fork has a branch-ordering quirk —
    ``elif tails[0] == "circular"`` (``splines.py:35``) catches *lists* of
    circular tails, pads the (num_bins+1)-slot derivatives to num_bins+2 and
    ties the padded slot, which the spline never gathers.  Net effect: the
    circular derivative tie is a NO-OP in every hybrid run (all num_bins+1
    derivatives free, no boundary-slope continuity).  ``circular_tie=True``
    (default) applies the mathematically intended tie (upstream-normflows
    semantics, continuous density on the torus); ``False`` reproduces the
    fork's effective untied behavior for parity testing.
    """
    constant = IDENTITY_DERIVATIVE_CONSTANT
    d = unnormalized_derivatives
    if isinstance(tails, str):
        if tails == "linear":
            const = jnp.full_like(d[..., :1], constant)
            return jnp.concatenate([const, d, const], axis=-1)
        elif tails == "circular":
            return jnp.concatenate([d, d[..., :1]], axis=-1)
        raise NotImplementedError(f"{tails} tails are not implemented.")
    # Mixed per-dimension tails: d has shape (..., D, num_bins + 1).
    tails = list(tails)
    ind_circ = np.array([t == "circular" for t in tails])
    ind_lin = np.array([t == "linear" for t in tails])
    if not np.all(ind_circ | ind_lin):
        raise NotImplementedError("per-dim tails must be linear/circular")
    circ = jnp.asarray(ind_circ)[..., None]  # (D, 1) broadcast over knots
    lin = jnp.asarray(ind_lin)
    first = d[..., :1]
    last = d[..., -1:]
    const = jnp.full_like(first, constant)
    new_first = jnp.where(lin[..., None], const, first)
    if circular_tie:
        new_last = jnp.where(circ, new_first,
                             jnp.where(lin[..., None], const, last))
    else:
        new_last = jnp.where(lin[..., None], const, last)
    return jnp.concatenate([new_first, d[..., 1:-1], new_last], axis=-1)


def unconstrained_rational_quadratic_spline(
    inputs: jnp.ndarray,
    unnormalized_widths: jnp.ndarray,
    unnormalized_heights: jnp.ndarray,
    unnormalized_derivatives: jnp.ndarray,
    inverse: bool = False,
    tails: Tails = "linear",
    tail_bound=1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
    circular_tie: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """RQ spline on [-tail_bound, tail_bound] with identity tails outside.

    Reference ``splines.py:16-88``.  Out-of-interval inputs pass through
    unchanged with zero log-det; in-interval inputs go through the spline.
    """
    tail_bound = jnp.asarray(tail_bound, dtype=inputs.dtype)
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)

    derivatives_padded = _pad_derivatives(unnormalized_derivatives, tails,
                                          circular_tie=circular_tie)

    # Clamp so the spline math stays finite for outside elements (which are
    # overwritten by the identity below).
    clamped = jnp.clip(inputs, -tail_bound, tail_bound)
    spline_out, spline_logdet = rational_quadratic_spline(
        clamped,
        unnormalized_widths,
        unnormalized_heights,
        derivatives_padded,
        inverse=inverse,
        left=-tail_bound,
        right=tail_bound,
        bottom=-tail_bound,
        top=tail_bound,
        min_bin_width=min_bin_width,
        min_bin_height=min_bin_height,
        min_derivative=min_derivative,
    )
    outputs = jnp.where(inside, spline_out, inputs)
    logabsdet = jnp.where(inside, spline_logdet, jnp.zeros_like(spline_logdet))
    return outputs, logabsdet
