"""The circle generator, the default of a traffic mix (``"generator"``
absent or ``"circle"``): ``rendered_frames`` poses on a horizontal circle
of ``radius_m`` above the heightmap world, ``frames_per_circle`` to a
circle, with ``wobble_m`` of height and ``look_jitter_rad`` of look around
(``reference/scene.circle_pose``), starting at a phase drawn from the seed.

A generator is a module ``traffic/<generator>.py`` with ``poses(traffic,
seed)``, the ground-truth ``global_T_frame`` (N, 4, 4) of the mix's N
distinct frames. It may also define ``world(traffic, seed)``,
``frames(camera, poses, world, depth_scaling, device)`` (u16 depth and u8
RGB host arrays of the poses) and ``surface_z(x, y, world)`` (the surface
the map is judged against); the heightmap world, its device renderer and
its analytic surface stand where it does not (``harness/spec.py``).
"""

import numpy as np

from portbench.reference import scene


def poses(traffic: dict, seed: int) -> np.ndarray:
  """Frame i at circle angle phase + 2 pi i / frames_per_circle."""
  _, phase = scene.seeded(seed)
  n = int(traffic["rendered_frames"])
  s = phase + 2.0 * np.pi * np.arange(n) / float(traffic["frames_per_circle"])
  return scene.circle_pose(s, float(traffic["radius_m"]),
                           float(traffic["wobble_m"]),
                           float(traffic["look_jitter_rad"]))
