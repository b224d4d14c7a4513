"""Polarization basis transformations (Mueller matrices).

Capability parity with the reference's ``polarization.py``: CASA Stokes
enumeration, least-squares Mueller matrices between arbitrary polarization
bases, and the circular-frame split used for parallactic-angle rotation
(reference ``polarization.py:34-133``).

The port's own copy of :mod:`katsdpimager_tpu.polarization` (host code, no kernel); the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

STOKES_I = 1
STOKES_Q = 2
STOKES_U = 3
STOKES_V = 4
STOKES_RR = 5
STOKES_RL = 6
STOKES_LR = 7
STOKES_LL = 8
STOKES_XX = 9
STOKES_XY = 10
STOKES_YX = 11
STOKES_YY = 12

STOKES_IQUV = [STOKES_I, STOKES_Q, STOKES_U, STOKES_V]
STOKES_CIRCULAR = [STOKES_RR, STOKES_RL, STOKES_LR, STOKES_LL]

#: Names for polarizations used in display and command line
STOKES_NAMES = [None, "I", "Q", "U", "V", "RR", "RL", "LR", "LL", "XX", "XY", "YX", "YY"]

#: Coefficients of each correlation product in terms of (I, Q, U, V).
#: Row p gives the linear combination of Stokes parameters measured by
#: product p (CASA enumeration; reference polarization.py:53-67).
STOKES_COEFF = np.array(
    [
        [0, 0, 0, 0],
        [1, 0, 0, 0],     # I
        [0, 1, 0, 0],     # Q
        [0, 0, 1, 0],     # U
        [0, 0, 0, 1],     # V
        [1, 0, 0, 1],     # RR = I + V
        [0, 1, 1j, 0],    # RL = Q + iU
        [0, 1, -1j, 0],   # LR = Q - iU
        [1, 0, 0, -1],    # LL = I - V
        [1, 1, 0, 0],     # XX = I + Q
        [0, 0, 1, 1j],    # XY = U + iV
        [0, 0, 1, -1j],   # YX = U - iV
        [1, -1, 0, 0],    # YY = I - Q
    ],
    np.complex64,
)


def polarization_matrix(outputs, inputs) -> np.ndarray:
    """Mueller matrix mapping correlation products `inputs` to `outputs`.

    Each product measures a fixed Gaussian-integer combination of the
    Stokes vector ``s`` (rows of :data:`STOKES_COEFF`): inputs observe
    ``A s``, outputs ``B s``, and the conversion ``M`` satisfies
    ``M A = B``.  A float least-squares solve only *proposes* ``M``; the
    returned matrix is certified exactly.  Because the Stokes coefficients
    lie in ``{0, ±1, ±i}`` and any invertible product basis has
    determinant of modulus 4, every realizable conversion has entries in
    ``(Z + iZ)/4``.  We therefore round ``4M`` to Gaussian integers and
    check ``(4M) A == 4B`` — small-integer complex arithmetic is exact in
    floating point — so the result carries no lstsq rounding noise at all
    (exact zeros matter for weight propagation).

    Raises ValueError when the inputs cannot produce the outputs.
    """
    A = STOKES_COEFF[list(inputs), :].astype(np.complex128)   # (n_in, 4)
    B = STOKES_COEFF[list(outputs), :].astype(np.complex128)  # (n_out, 4)
    # Solve A^T M^T = B^T for the proposal (least-norm when inputs are
    # linearly dependent; least-squares residual when they don't span).
    Mt, _res, _rank, _sv = np.linalg.lstsq(A.T, B.T, rcond=None)
    M = Mt.T                                                  # (n_out, n_in)
    M4 = np.round(M.real * 4) + 1j * np.round(M.imag * 4)
    if np.array_equal(M4 @ A, 4 * B):
        M = M4 * 0.25
    elif not np.allclose(M @ A, B, atol=1e-9):
        raise ValueError(
            "no solution: inputs cannot produce requested outputs")
    return np.ascontiguousarray(M.astype(np.complex64))


def polarization_matrices(outputs, inputs):
    """Mueller matrix pair for conversion via the circular (R/L) frame.

    Returns ``(from_circular, to_circular)``: parallactic/feed-angle rotation
    is diagonal in the circular frame, so per-visibility rotation is applied
    between these two constant matrices (see :mod:`.preprocess`).
    """
    return (polarization_matrix(outputs, STOKES_CIRCULAR),
            polarization_matrix(STOKES_CIRCULAR, inputs))


def parse_stokes(str_value):
    """Parse a string like ``IQUV`` into a sorted list of enum values."""
    for p in str_value:
        if p not in "IQUV":
            raise ValueError(f"Invalid Stokes parameter {p}")
    if not str_value:
        raise ValueError("Empty Stokes parameter list")
    ans = []
    for p in "IQUV":
        cnt = str_value.count(p)
        if cnt > 1:
            raise ValueError(f"Stokes parameter {p} listed multiple times")
        elif cnt:
            ans.append(STOKES_NAMES.index(p))
    return sorted(ans)


def unparse_stokes(params):
    return "".join(STOKES_NAMES[idx] for idx in params)
