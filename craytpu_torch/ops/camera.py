"""Camera ray generation (pinhole + thin-lens DoF) with tent-filter jitter.

Mirrors datatypes/camera.c:22-87. The camera is fixed at scene compile time,
so `make_camera_ray_fn` bakes all host scalars (FOV-derived sensor size,
aperture, composite transform) into the returned function; the DoF branch
is resolved on the host like the C `if (cam->aperture > 0.0f)`.

Dimension consumption order per ray (parity-critical):
  jitterX, jitterY, then (aperture > 0 only) disc r, disc theta.
"""

from __future__ import annotations

import numpy as np
import torch

from craytpu_torch.ops import sampler as smp
from craytpu_torch.ops import vecmath as vm


class CameraHost:
    """Host-side camera (struct camera, camera.c:22-42)."""

    def __init__(self, width: int, height: int, fov: float,
                 focal_distance: float, fstops: float, composite_A):
        import numpy as np
        self.width = int(width)
        self.height = int(height)
        self.fov = float(fov)
        self.focal_distance = float(focal_distance)
        self.fstops = float(fstops)
        self.A = np.asarray(composite_A, np.float32)
        self.aspect = np.float32(width) / np.float32(height)
        fov_rad = np.float32(np.float32(fov) * np.float32(np.pi)) / np.float32(180.0)
        self.sensor_x = np.float32(2.0) * np.float32(np.tan(fov_rad / np.float32(2.0)))
        self.sensor_y = np.float32(self.sensor_x / self.aspect)
        # 35mm-sensor focal length quirk kept for config compatibility
        # (camera.c:34-39)
        sensor_width_35mm = np.float32(0.036)
        self.focal_length = np.float32(0.5) * sensor_width_35mm / np.float32(
            np.float32(0.5) * fov_rad)
        self.aperture = (np.float32(0.5) * (self.focal_length / np.float32(fstops))
                         if fstops != 0.0 else np.float32(0.0))
        # updateCam with lookAt=(0,0,1), worldUp=(0,1,0) (camera.c:16-20,:33)
        self.forward = np.array([0.0, 0.0, 1.0], np.float32)
        self.right = np.array([1.0, 0.0, 0.0], np.float32)
        self.up = np.array([0.0, 1.0, 0.0], np.float32)


def make_camera_ray_fn(cam: CameraHost, kind: str, device):
    """Returns get_ray(xs, ys, sampler_state) -> (start (B,3),
    direction (B,3), state) for (B,) integer pixel coordinates."""
    f32 = np.float32

    def vec3(v):
        return torch.tensor(np.asarray(v, f32), device=device)

    forward = vec3(cam.forward)
    right = vec3(cam.right)
    up = vec3(cam.up)
    pix_x = right * float(f32(cam.sensor_x) / f32(cam.width))
    pix_y = up * float(f32(cam.sensor_y) / f32(cam.height))
    half_w = float(f32(cam.width * 0.5))
    half_h = float(f32(cam.height * 0.5))
    A = torch.tensor(np.asarray(cam.A, f32)[:3, :4], device=device)
    aperture = float(cam.aperture)
    focal_distance = float(f32(cam.focal_distance))

    def get_ray(xs, ys, s: smp.SamplerState):
        d1, s = smp.get_dimension(kind, s)
        d2, s = smp.get_dimension(kind, s)
        jx = vm.triangle_distribution(d1)
        jy = vm.triangle_distribution(d2)
        px = xs.to(torch.float32) - half_w + jx + 0.5
        py = ys.to(torch.float32) - half_h + jy + 0.5
        # reference-binary rounding: pixV = forward + fma(pixX, px,
        # pixY*py) per component (getCameraRay disassembly)
        pix_v = forward + vm.fma_raw(pix_x, px[:, None],
                                     pix_y * py[:, None])
        direction = vm.vnormalize(pix_v)
        start = torch.zeros_like(direction)

        if aperture > 0.0:  # camera.c:77-83
            ft = vm.exact_div(torch.full_like(px, focal_distance),
                              vm.vdot(direction, forward))
            focus_point = start + direction * ft[:, None]
            lx, ly, s = vm.random_coord_on_unit_disc(kind, s)
            lens = (right * (aperture * lx)[:, None]
                    + up * (aperture * ly)[:, None])
            start = start + lens
            direction = vm.vnormalize(focus_point - start)

        # To world space (camera.c:85): transformRay by composite.A,
        # explicit chains (vm.mat34_point), never a matmul
        return vm.mat34_point(A, start), vm.mat33_vec(A, direction), s

    return get_ray
