"""Camera models and 3D geometry (PyTorch port of ``ops/geometry.py``).

Pinhole cameras with the principal point at the image center, +Z into the
screen (OpenCV camera space). Depth maps are (..., H, W) float meters,
point maps (..., H, W, 3), transforms (..., 4, 4). Everything broadcasts
over leading batch axes.
"""

from __future__ import annotations

import torch


def camera_matrix_from_fov(width, height, xfov_deg=None, yfov_deg=None,
                           device=None):
    """3x3 float32 intrinsics from horizontal and/or vertical FOV (deg).

    With one FOV the other focal length equals it (square pixels). The
    arithmetic is float32, as in the JAX package."""
    if xfov_deg is None and yfov_deg is None:
        raise ValueError("need xfov_deg or yfov_deg")

    def focal(size, fov):
        f = torch.tensor(fov, dtype=torch.float32, device=device)
        return size / (2.0 * torch.tan(torch.deg2rad(f) / 2.0))

    fx = focal(width, xfov_deg) if xfov_deg is not None else None
    fy = focal(height, yfov_deg) if yfov_deg is not None else None
    fx = fy if fx is None else fx
    fy = fx if fy is None else fy
    k = torch.zeros(fx.shape + (3, 3), dtype=torch.float32, device=device)
    k[..., 0, 0] = fx
    k[..., 1, 1] = fy
    k[..., 0, 2] = width / 2.0
    k[..., 1, 2] = height / 2.0
    k[..., 2, 2] = 1.0
    return k


def pixel_grid(height, width, of_by_one=False, device=None):
    """(H, W) pixel coordinate grids (x, y); ``of_by_one`` applies the
    mesh-path (W+1)/W, (H+1)/H stretch."""
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device)
    if of_by_one:
        x = x * ((width + 1.0) / width)
        y = y * ((height + 1.0) / height)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    return gx, gy


def _intrinsics(k):
    return (k[..., 0, 0, None, None], k[..., 1, 1, None, None],
            k[..., 0, 2, None, None], k[..., 1, 2, None, None])


def unproject_depth(depth, k, of_by_one=False):
    """Depth (..., H, W) -> camera-space points (..., H, W, 3)."""
    h, w = depth.shape[-2:]
    x, y = pixel_grid(h, w, of_by_one=of_by_one, device=depth.device)
    fx, fy, cx, cy = _intrinsics(k)
    z = depth.to(torch.float32)
    return torch.stack([(x - cx) * z / fx, (y - cy) * z / fy, z], dim=-1)


def normals_from_depth(depth, k, directx=True):
    """Per-pixel normals from forward differences of unprojected points,
    with the Y axis flipped before the cross product and the DirectX
    Y/Z flip after it (as the JAX package and its upstream do)."""
    h, w = depth.shape[-2:]
    x, y = pixel_grid(h, w, device=depth.device)
    fx, fy, cx, cy = _intrinsics(k)
    z = depth.to(torch.float32)
    p = torch.stack([(x - cx) / fx * z, (cy - y) / fy * z, z], dim=-1)
    p_x1 = torch.cat([p[..., :, 1:, :], p[..., :, -1:, :]], dim=-2)
    p_y1 = torch.cat([p[..., 1:, :, :], p[..., -1:, :, :]], dim=-3)
    n = torch.linalg.cross(p_x1 - p, p_y1 - p, dim=-1)
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-8)
    if directx:
        n = n * torch.tensor([1.0, -1.0, -1.0], dtype=n.dtype,
                             device=n.device)
    return n


def rotation_y(angle_rad):
    """(...) angles -> (..., 4, 4) rotations about +Y."""
    a = torch.as_tensor(angle_rad, dtype=torch.float32)
    c, s = torch.cos(a), torch.sin(a)
    m = torch.zeros(a.shape + (4, 4), dtype=torch.float32, device=a.device)
    m[..., 0, 0] = c
    m[..., 0, 2] = s
    m[..., 1, 1] = 1.0
    m[..., 2, 0] = -s
    m[..., 2, 2] = c
    m[..., 3, 3] = 1.0
    return m


def translation_matrix(x, y, z):
    """(...) offsets -> (..., 4, 4) translations (y, z broadcast to x)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    m = torch.eye(4, dtype=torch.float32, device=x.device).expand(
        x.shape + (4, 4)).clone()
    m[..., 0, 3] = x
    m[..., 1, 3] = y
    m[..., 2, 3] = z
    return m


def convergence_angle(distance, pupillary_distance):
    """Per-eye toe-in so both eyes look at ``distance``:
    atan((IPD/2) / d)."""
    d = torch.as_tensor(distance, dtype=torch.float32)
    return torch.atan2(torch.full_like(d, pupillary_distance / 2.0), d)


def fov_from_camera_matrix(k):
    """(xfov_deg, yfov_deg) of intrinsics k (..., 3, 3) with a centered
    principal point, in float32."""
    w = k[..., 0, 2] * 2.0
    h = k[..., 1, 2] * 2.0
    return (torch.rad2deg(2.0 * torch.atan2(w, 2.0 * k[..., 0, 0])),
            torch.rad2deg(2.0 * torch.atan2(h, 2.0 * k[..., 1, 1])))


def project_points(points, k, eps=1e-9):
    """Camera-space points (..., N, 3) -> pixel coordinates (..., N, 2)
    and depth (..., N) through intrinsics k (..., 3, 3); pinhole, no
    distortion."""
    z = points[..., 2]
    safe_z = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    u = points[..., 0] / safe_z * k[..., 0, 0, None] + k[..., 0, 2, None]
    v = points[..., 1] / safe_z * k[..., 1, 1, None] + k[..., 1, 2, None]
    return torch.stack([u, v], dim=-1), z


def transform_points(points, transform):
    """(..., N, 3) points through (..., 4, 4) homogeneous transforms."""
    return (torch.einsum("...ij,...nj->...ni", transform[..., :3, :3],
                         points) + transform[..., None, :3, 3])


def transform_depth_map(points_hw3, transform):
    """(..., H, W, 3) image-shaped point maps through (..., 4, 4)
    transforms."""
    return (torch.einsum("...ij,...hwj->...hwi", transform[..., :3, :3],
                         points_hw3) + transform[..., None, None, :3, 3])


def look_at(eye, target, up):
    """Right-handed look-at view matrix (4, 4), GL convention: the camera
    looks down -Z."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    up = torch.as_tensor(up, dtype=torch.float32)
    f = target - eye
    f = f / (torch.linalg.vector_norm(f) + 1e-12)
    s = torch.linalg.cross(f, up)
    s = s / (torch.linalg.vector_norm(s) + 1e-12)
    u = torch.linalg.cross(s, f)
    m = torch.eye(4, dtype=torch.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = m[:3, :3] @ (-eye)
    return m


def frustum_corners(k, width, height, near, far, cam_to_world=None):
    """(8, 3) frustum corner points of intrinsics k (3, 3): the near
    plane's four, then the far plane's, optionally through a 4x4
    camera-to-world transform."""
    fx, fy = k[..., 0, 0], k[..., 1, 1]
    cx, cy = k[..., 0, 2], k[..., 1, 2]
    xs = torch.tensor([0.0, width, width, 0.0], dtype=torch.float32)
    ys = torch.tensor([0.0, 0.0, height, height], dtype=torch.float32)
    dirs = torch.stack([(xs - cx) / fx, (ys - cy) / fy,
                        torch.ones(4, dtype=torch.float32)], dim=-1)
    corners = torch.cat([dirs * near, dirs * far], dim=0)
    if cam_to_world is not None:
        corners = transform_points(corners[None], cam_to_world)[0]
    return corners
