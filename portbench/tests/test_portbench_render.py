"""The device renderer of the traffic against the reference's numpy
renderer, and the traffic's poses."""

import numpy as np
import pytest
import torch

from portbench.harness import render, spec
from portbench.reference import scene

CIRCLE = spec.load_generator(spec.ROOT, "circle")

TRAFFIC = {"world": {"z_distance": 1.0, "z_variation": 0.05,
                     "texture_cell": 0.02},
           "radius_m": 0.25, "frames_per_circle": 250, "wobble_m": 0.03,
           "look_jitter_rad": 0.06, "rendered_frames": 6, "cyclic": True}


@pytest.mark.parametrize("seed", [0, 2**31 + 12345])
def test_torch_render_matches_numpy_reference(seed):
  cam = scene.Camera(160, 120, 131.25, 131.25, 80.0, 60.0)
  world = scene.world_of(TRAFFIC, seed)
  poses = CIRCLE.poses(TRAFFIC, seed)
  depth, rgb = render.render_frames(cam, poses, world, 5000.0,
                                    torch.device("cpu"))
  for i, pose in enumerate(poses):
    want_d, want_g = scene.render(cam, pose, world, 5000.0)
    diff_d = np.abs(depth[i].astype(np.int64) - want_d.astype(np.int64))
    diff_g = np.abs(rgb[i, ..., 0].astype(np.int64) - want_g.astype(np.int64))
    # Float64 sums in another order may flip a rounding: one step, rarely.
    assert diff_d.max() <= 1 and (diff_d > 0).mean() < 1e-3
    assert diff_g.max() <= 1 and (diff_g > 0).mean() < 1e-3
    assert (want_d > 0).mean() > 0.9
    assert np.array_equal(rgb[i, ..., 0], rgb[i, ..., 2])


def test_trajectory_speed_and_cycle():
  poses = CIRCLE.poses(dict(TRAFFIC, rendered_frames=250), 7)
  steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
  # 2 pi 0.25 m / 250 frames in the plane, with the height wobble.
  assert 0.0060 < steps.mean() < 0.0066
  # The circle closes: frame 250 would be frame 0 again.
  s = scene.seeded(7)[1] + 2 * np.pi * 250 / 250
  closing = scene.circle_pose(np.array([s]), 0.25, 0.03, 0.06)[0]
  assert np.allclose(closing, poses[0], atol=1e-5)
  assert np.array_equal(poses[scene.pose_index(poses, {"cyclic": True}, 251)],
                        poses[1])


def test_seed_draws_world_and_phase():
  a, b = scene.seeded(1), scene.seeded(2)
  assert a != b and scene.seeded(1) == a
  assert 0 <= a[0] < 1 << 20 and 0.0 <= a[1] < 2 * np.pi
