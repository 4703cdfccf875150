"""Exact-quadrature oracle for the single-particle double-well system."""

import jax.numpy as jnp
import numpy as np

from flowstate.ops import Box, SystemSpec, double_well_potential


def single_particle_spec() -> SystemSpec:
    """Single particle in the asymmetric double well (no LJ partner)."""
    box = Box.from_density(1, 0.01, 1.0)  # 10x10 box
    return SystemSpec.create(1, box, num_wells=2, V0_list=(-2.0, -2.5),
                             r0=1.2, k=15.0)


def exact_well_delta_f(spec: SystemSpec, beta: float) -> float:
    """ΔF = ln(Z_B / Z_A) by quadrature of exp(-beta V) over the well disks
    (r <= 1.1 * r0, the reference's well classification radius)."""
    lx, ly = spec.box.size_x, spec.box.size_y
    g = 400
    xs = np.linspace(0, lx, g, endpoint=False) + lx / g / 2
    ys = np.linspace(0, ly, g, endpoint=False) + ly / g / 2
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    pts = jnp.asarray(np.stack([xx.ravel(), yy.ravel()], axis=-1))
    V = np.asarray(double_well_potential(pts, lx, ly,
                                         V0_list=list(spec.V0_list),
                                         r0=spec.r0, k=spec.k)).reshape(g, g)
    w = np.exp(-beta * V)
    radius = 1.1 * spec.r0
    d_a = np.hypot(xx - lx / 4, yy - ly / 2) <= radius
    d_b = np.hypot(xx - 3 * lx / 4, yy - ly / 2) <= radius
    return float(np.log(w[d_b].sum() / w[d_a].sum()))


def sampled_well_delta_f(spec: SystemSpec, positions) -> float:
    """ΔF = ln(n_B / n_A) from sampled single-particle positions."""
    lx, ly = spec.box.size_x, spec.box.size_y
    xy = np.asarray(positions).reshape(-1, 2)
    radius = 1.1 * spec.r0
    in_a = np.hypot(*(xy - [lx / 4, ly / 2]).T) <= radius
    in_b = np.hypot(*(xy - [3 * lx / 4, ly / 2]).T) <= radius
    return float(np.log(in_b.sum() / in_a.sum()))


def split_start(spec: SystemSpec, num_chains: int) -> np.ndarray:
    """(C, 1, 2) starts: half the chains in well A, half in well B."""
    lx, ly = spec.box.size_x, spec.box.size_y
    pos0 = np.tile(np.array([[lx / 4, ly / 2]]), (num_chains, 1, 1))
    pos0[num_chains // 2:, :, 0] = 3 * lx / 4
    return pos0
