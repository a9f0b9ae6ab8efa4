"""Rotation codecs on the device for the pose embedding and the action
decodes (port of robot3dlotus_tpu/ops/rotation.py).

Conventions match scipy.spatial.transform.Rotation: quaternions are xyzw,
euler angles are extrinsic 'xyz' (R = Rz @ Ry @ Rx), and in gimbal lock
(|beta| = 90 deg) the third angle is 0.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def normalize(v, dim=-1, eps=_EPS):
    mag = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))
    return v / torch.clamp(mag, min=eps)


def quat_to_matrix(q):
    """(..., 4) xyzw -> (..., 3, 3); q is normalised first."""
    q = normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def euler_to_matrix(euler, degrees=False):
    """(..., 3) [alpha, beta, gamma] -> (..., 3, 3), R = Rz @ Ry @ Rx."""
    e = euler * (math.pi / 180.0) if degrees else euler
    a, b, c = e[..., 0], e[..., 1], e[..., 2]
    sa, ca = torch.sin(a), torch.cos(a)
    sb, cb = torch.sin(b), torch.cos(b)
    sc, cc = torch.sin(c), torch.cos(c)
    m = torch.stack([
        cb * cc, sa * sb * cc - ca * sc, ca * sb * cc + sa * sc,
        cb * sc, sa * sb * sc + ca * cc, ca * sb * sc - sa * cc,
        -sb, sa * cb, ca * cb,
    ], dim=-1)
    return m.reshape(e.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """(..., 3, 3) -> (..., 4) xyzw, branchless Shepperd (largest pivot)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = m00 + m11 + m22
    qx2 = m00 - m11 - m22
    qy2 = m11 - m00 - m22
    qz2 = m22 - m00 - m11

    def s_of(p):
        return torch.sqrt(torch.clamp(1.0 + p, min=_EPS)) * 2

    sw, sx, sy, sz = s_of(qw2), s_of(qx2), s_of(qy2), s_of(qz2)
    cands = torch.stack([
        torch.stack([(m21 - m12) / sw, (m02 - m20) / sw,
                     (m10 - m01) / sw, sw / 4], -1),
        torch.stack([sx / 4, (m01 + m10) / sx,
                     (m02 + m20) / sx, (m21 - m12) / sx], -1),
        torch.stack([(m01 + m10) / sy, sy / 4,
                     (m12 + m21) / sy, (m02 - m20) / sy], -1),
        torch.stack([(m02 + m20) / sz, (m12 + m21) / sz,
                     sz / 4, (m10 - m01) / sz], -1),
    ], dim=-2)
    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    return normalize(q)


def matrix_to_euler(m, degrees=False):
    """Inverse of euler_to_matrix, the third angle 0 in gimbal lock."""
    sb = -m[..., 2, 0]
    b = torch.asin(torch.clamp(sb, -1.0, 1.0))
    locked = sb.abs() > 1.0 - 1e-7
    a_free = torch.atan2(m[..., 2, 1], m[..., 2, 2])
    c_free = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    # beta = +90: R[0,1] = sin(a - c), R[1,1] = cos(a - c); beta = -90:
    # R[0,1] = -sin(a + c), R[1,1] = cos(a + c); c = 0 in both
    a_lock = torch.where(sb > 0, torch.atan2(m[..., 0, 1], m[..., 1, 1]),
                         torch.atan2(-m[..., 0, 1], m[..., 1, 1]))
    a = torch.where(locked, a_lock, a_free)
    c = torch.where(locked, torch.zeros_like(c_free), c_free)
    e = torch.stack([a, b, c], dim=-1)
    return e * (180.0 / math.pi) if degrees else e


def euler_to_quat(euler, degrees=False):
    return matrix_to_quat(euler_to_matrix(euler, degrees))


def quat_to_euler(q, degrees=False):
    return matrix_to_euler(quat_to_matrix(q), degrees)


def rot6d_to_matrix(poses):
    """(..., 6) -> (..., 3, 3) with columns x, y, z (Gram-Schmidt)."""
    x = normalize(poses[..., 0:3])
    z = normalize(torch.linalg.cross(x, poses[..., 3:6]))
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def discrete_euler_to_quat(disc, resolution):
    """(..., 3) integer bins -> (..., 4) xyzw quaternion."""
    euler = disc.to(torch.float32) * resolution - 180.0
    return euler_to_quat(euler, degrees=True)
