"""Contact LCPs made from a seed, for holding DANTZIG's pivot kernel to its
plain version where a scene gives too few contacts.

``random_contact_lcp`` forms the system as ``ops/lcp._build_lcp`` does for
random contacts between free bodies: one normal and two friction rows a
contact, R = 3C rows ordered [normal | t1 | t2], A = J M⁻¹ Jᵀ + (cfm/dt)·I
(symmetric positive definite), b = J v − target. With more bodies than
contacts J has full rank, so every row may be valid and the system stays
well conditioned: a world of all its rows valid is the kernel's large
tier and its blocked elimination. ``tier_boundary_lcp`` gives one world at
each of the kernel's tier boundaries, ``block_cycle_lcp`` one world in each
tier on which block pivoting cycles.
"""

from __future__ import annotations

import numpy as np


def random_contact_lcp(seed: int, worlds: int = 4, contacts: int = 12,
                       bodies: int = 16, mu=None, live: float = 0.7):
    """(A (B, R, R), b (B, R), valid (B, R), is_normal (B, R), μ (B, C) or
    None) as float64 and bool numpy arrays: each contact between two random
    bodies of unit-range inverse masses, with a random unit normal, lever
    arms in [−0.5, 0.5]³ and a target in [0, 0.2] on its normal row; a
    contact valid with probability ``live``. ``mu``: None (all ∞), a float,
    or "mixed" (a μ in [0.2, 1] a contact, a third of them ∞)."""
    rng = np.random.default_rng(seed)
    c, r = contacts, 3 * contacts
    a_out = np.empty((worlds, r, r))
    b_out = np.empty((worlds, r))
    for w in range(worlds):
        jac = np.zeros((r, 6 * bodies))
        for k in range(c):
            ba, bb = rng.choice(bodies, 2, replace=False)
            n = rng.normal(size=3)
            n /= np.linalg.norm(n)
            t1 = np.cross(n, rng.normal(size=3))
            t1 /= np.linalg.norm(t1)
            t2 = np.cross(n, t1)
            ra, rb = rng.uniform(-0.5, 0.5, (2, 3))
            for row, u in ((k, n), (c + k, t1), (2 * c + k, t2)):
                jac[row, 6 * bb:6 * bb + 6] = np.r_[u, np.cross(rb, u)]
                jac[row, 6 * ba:6 * ba + 6] -= np.r_[u, np.cross(ra, u)]
        inv_m = np.repeat(rng.uniform(0.5, 2.0, bodies), 6)
        a_out[w] = (jac * inv_m) @ jac.T + 6e-4 * np.eye(r)
        target = np.r_[rng.uniform(0.0, 0.2, c), np.zeros(2 * c)]
        b_out[w] = jac @ rng.normal(size=6 * bodies) - target
    valid = np.tile(rng.random((worlds, c)) < live, 3)
    is_normal = np.zeros((worlds, r), bool)
    is_normal[:, :c] = True
    if mu is None:
        mu_row = None
    elif mu == "mixed":
        mu_row = rng.uniform(0.2, 1.0, (worlds, c))
        mu_row[:, ::3] = np.inf
    else:
        mu_row = np.full((worlds, c), float(mu))
    return a_out, b_out, valid, is_normal, mu_row


def valid_of_count(count: int, contacts: int):
    """(3 · contacts,) bool: ``count`` valid rows, whole contacts first
    (their normal, t1 and t2 rows), then the next contact's normal row and
    its t1 row."""
    k, extra = divmod(count, 3)
    valid = np.tile(np.arange(contacts) < k, 3)
    if extra >= 1:
        valid[k] = True
    if extra == 2:
        valid[contacts + k] = True
    return valid


def tier_boundary_lcp(counts, seed: int = 13, mu=None, contacts: int = 96):
    """``random_contact_lcp`` of ``contacts`` contacts (R = 288 by default)
    between max(128, ``contacts``) bodies, world i with ``counts[i]`` valid
    rows (``valid_of_count``): e.g. ``ops/lcp_kernel.boundary_counts``.
    Every normal row is pressed (b < 0), so that under μ = ∞ every valid
    row is active in the first round: a world's first active block is its
    valid count, and the kernel's switches on the active count are met at
    the counts given."""
    a_mat, b, valid, is_normal, mu_row = random_contact_lcp(
        seed, worlds=len(counts), contacts=contacts,
        bodies=max(128, contacts), mu=mu, live=1.0)
    b[:, :contacts] = -np.abs(b[:, :contacts]) - 0.01
    for w, count in enumerate(counts):
        valid[w] = valid_of_count(count, contacts)
    return a_mat, b, valid, is_normal, mu_row


# (seed, contacts, bodies, world) of ``random_contact_lcp`` systems, every
# row valid and μ = ∞, on which flipping every violating row at once
# cycles to the round cap: 30, 63 and 144 valid rows, one in each of the
# kernel's tiers (staged, medium, large)
BLOCK_CYCLES = ((36, 10, 6, 5), (35, 21, 12, 11), (9, 48, 24, 7))


def block_cycle_lcp(contacts: int = 48):
    """The ``BLOCK_CYCLES`` worlds as one batch of R = 3 · ``contacts``
    rows, float64 and bool numpy arrays (A, b, valid, is_normal): each
    system's contact k in contact slot k, the slots past its contacts
    invalid (identity rows of A, b = 0)."""
    r = 3 * contacts
    out_a = np.tile(np.eye(r), (len(BLOCK_CYCLES), 1, 1))
    out_b = np.zeros((len(BLOCK_CYCLES), r))
    valid = np.zeros((len(BLOCK_CYCLES), r), bool)
    for w, (seed, c, bodies, world) in enumerate(BLOCK_CYCLES):
        a_mat, b, _, _, _ = random_contact_lcp(
            seed, worlds=world + 1, contacts=c, bodies=bodies, live=1.0)
        rows = np.concatenate([blk * contacts + np.arange(c)
                               for blk in range(3)])
        out_a[w][np.ix_(rows, rows)] = a_mat[world]
        out_b[w][rows] = b[world]
        valid[w][rows] = True
    is_normal = np.zeros((len(BLOCK_CYCLES), r), bool)
    is_normal[:, :contacts] = True
    return out_a, out_b, valid, is_normal
