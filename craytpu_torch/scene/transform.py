"""Host-side 4x4 transforms with the reference's exact semantics.

Mirrors datatypes/transforms.c: row-major matrices, rotate/translate/scale
constructors, adjoint/determinant inverse (fatal on det <= 0, bug-compatible
with transforms.c:261-267), transpose-multiplied normals, and the
absolute-matrix bbox transform. Composite ordering follows
sceneloader.c:716-756: translates first, then rotates, then scales, each in
listed order.

All math is float32 numpy to track the C float pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from craytpu_torch.utils import logging

F = np.float32

IDENTITY = "identity"
X_ROTATE = "rotateX"
Y_ROTATE = "rotateY"
Z_ROTATE = "rotateZ"
TRANSLATE = "translate"
SCALE = "scale"
COMPOSITE = "composite"


def identity() -> np.ndarray:
    return np.eye(4, dtype=F)


@dataclass
class Transform:
    kind: str = IDENTITY
    A: np.ndarray = field(default_factory=identity)
    Ainv: np.ndarray = field(default_factory=identity)


def to_radians(deg: float) -> float:
    return F(F(deg) * F(np.pi)) / F(180.0)


def rotate_x(rads: float) -> Transform:
    c, s = F(np.cos(F(rads))), F(np.sin(F(rads)))
    A = identity()
    A[1, 1] = c
    A[1, 2] = -s
    A[2, 1] = s
    A[2, 2] = c
    return Transform(X_ROTATE, A, inverse(A))


def rotate_y(rads: float) -> Transform:
    c, s = F(np.cos(F(rads))), F(np.sin(F(rads)))
    A = identity()
    A[0, 0] = c
    A[0, 2] = s
    A[2, 0] = -s
    A[2, 2] = c
    return Transform(Y_ROTATE, A, inverse(A))


def rotate_z(rads: float) -> Transform:
    c, s = F(np.cos(F(rads))), F(np.sin(F(rads)))
    A = identity()
    A[0, 0] = c
    A[0, 1] = -s
    A[1, 0] = s
    A[1, 1] = c
    return Transform(Z_ROTATE, A, inverse(A))


def translate(x: float, y: float, z: float) -> Transform:
    A = identity()
    A[0, 3] = F(x)
    A[1, 3] = F(y)
    A[2, 3] = F(z)
    return Transform(TRANSLATE, A, inverse(A))


def scale(x: float, y: float, z: float) -> Transform:
    assert x != 0.0 and y != 0.0 and z != 0.0
    A = identity()
    A[0, 0] = F(x)
    A[1, 1] = F(y)
    A[2, 2] = F(z)
    return Transform(SCALE, A, inverse(A))


def scale_uniform(s: float) -> Transform:
    return Transform(SCALE, scale(s, s, s).A, scale(s, s, s).Ainv)


def det4(A: np.ndarray) -> float:
    """Hand-expanded 4x4 determinant (transforms.c:221-227), float32."""
    A = A.astype(F)

    def d2(a, b, c, d):
        return F(a * d - b * c)

    m = A
    top_left = m[0, 0] * (m[1, 1] * d2(m[2, 2], m[2, 3], m[3, 2], m[3, 3])
                          - m[1, 2] * d2(m[2, 1], m[2, 3], m[3, 1], m[3, 3])
                          + m[1, 3] * d2(m[2, 1], m[2, 2], m[3, 1], m[3, 2]))
    top_right = m[0, 1] * (m[1, 0] * d2(m[2, 2], m[2, 3], m[3, 2], m[3, 3])
                           - m[1, 2] * d2(m[2, 0], m[2, 3], m[3, 0], m[3, 3])
                           + m[1, 3] * d2(m[2, 0], m[2, 2], m[3, 0], m[3, 2]))
    bot_left = m[0, 2] * (m[1, 0] * d2(m[2, 1], m[2, 3], m[3, 1], m[3, 3])
                          - m[1, 1] * d2(m[2, 0], m[2, 3], m[3, 0], m[3, 3])
                          + m[1, 3] * d2(m[2, 0], m[2, 1], m[3, 0], m[3, 1]))
    bot_right = m[0, 3] * (m[1, 0] * d2(m[2, 1], m[2, 2], m[3, 1], m[3, 2])
                           - m[1, 1] * d2(m[2, 0], m[2, 2], m[3, 0], m[3, 2])
                           + m[1, 2] * d2(m[2, 0], m[2, 1], m[3, 0], m[3, 1]))
    return F(top_left - top_right + bot_left - bot_right)


def inverse(A: np.ndarray) -> np.ndarray:
    """Adjoint/determinant inverse (transforms.c:261-281).

    Fatal when det <= 0, matching the reference (which rejects mirrored
    and degenerate transforms the same way).
    """
    A = A.astype(F)
    det = det4(A)
    if det <= 0.0:
        logging.error("No inverse for given transform!")
    # cofactor matrix
    cof = np.zeros((4, 4), dtype=F)
    for i in range(4):
        for j in range(4):
            minor = np.delete(np.delete(A, i, axis=0), j, axis=1)
            sign = F(1.0) if (i + j) % 2 == 0 else F(-1.0)
            cof[i, j] = sign * det3(minor)
    inv = (cof / det).astype(F)
    return inv.T.copy()  # transforms.c:278-280


def det3(m: np.ndarray) -> float:
    m = m.astype(F)
    return F(m[0, 0] * F(m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
             - m[0, 1] * F(m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
             + m[0, 2] * F(m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))


def multiply(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    return (A.astype(F) @ B.astype(F)).astype(F)


def compose(transforms: list[Transform]) -> Transform:
    """parseTransformComposite (sceneloader.c:716-756).

    Order: all translates (in listed order), then all rotates, then all
    scales; composite.Ainv computed from the final matrix.
    """
    A = identity()
    for t in transforms:
        if t.kind == TRANSLATE:
            A = multiply(A, t.A)
    for t in transforms:
        if t.kind in (X_ROTATE, Y_ROTATE, Z_ROTATE):
            A = multiply(A, t.A)
    for t in transforms:
        if t.kind == SCALE:
            A = multiply(A, t.A)
    return Transform(COMPOSITE, A, inverse(A))


def transform_point(p: np.ndarray, A: np.ndarray) -> np.ndarray:
    return (A[:3, :3] @ p.astype(F) + A[:3, 3]).astype(F)


def transform_vector(v: np.ndarray, A: np.ndarray) -> np.ndarray:
    return (A[:3, :3] @ v.astype(F)).astype(F)


def transform_bbox(bmin: np.ndarray, bmax: np.ndarray, A: np.ndarray):
    """transformBBox via the absolute-matrix trick (transforms.c:86-94)."""
    absA = np.abs(A[:3, :3]).astype(F)
    center = ((bmin + bmax) * F(0.5)).astype(F)
    half = ((bmax - bmin) * F(0.5)).astype(F)
    new_half = (absA @ half).astype(F)
    new_center = (A[:3, :3] @ center + A[:3, 3]).astype(F)
    return (new_center - new_half).astype(F), (new_center + new_half).astype(F)
