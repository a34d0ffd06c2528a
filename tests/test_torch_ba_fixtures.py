"""Shared fixtures of the BA parity tests (``tests/test_torch_stores.py``,
``test_torch_ba_models.py``, ``test_torch_surfel_ops.py``,
``test_torch_direct_ba.py``): the same numpy inputs go into a JAX ``DirectBA``
and into the port's, on the CPU, at 160x120 with sparsification cell 2. This
module holds helpers only.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from badslam_tpu.config import BadSlamConfig as JaxConfig
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.slam.direct_ba import DirectBA as JaxDirectBA
from badslam_tpu.utils import synthetic as jsynthetic
from badslam_tpu_torch.config import BadSlamConfig as PortConfig
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.slam.direct_ba import DirectBA as PortDirectBA
from badslam_tpu_torch.utils import synthetic

torch.set_num_threads(2)

W, H = 160, 120
CELL = 2
HOST_MIRRORS = ("_kf_count_host", "_kf_valid_host",
                "last_active_in_ba_iteration", "ba_iteration_count",
                "last_ba_iteration_count")


def configs(**overrides):
  """The JAX configuration and the port's, field for field."""
  kwargs = dict(
      sparse_surfel_cell_size=CELL,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1,
      min_observation_count=1,
      initial_keyframe_capacity=4,
      initial_surfel_capacity=1 << 14)
  kwargs.update(overrides)
  jcfg = JaxConfig(**kwargs)
  return jcfg, PortConfig(**dataclasses.asdict(jcfg))


def cameras():
  return (jsynthetic.default_test_camera(W, H),
          synthetic.default_test_camera(W, H))


def make_pair(**overrides):
  """(JAX DirectBA, port DirectBA on the CPU), both empty."""
  jcfg, pcfg = configs(**overrides)
  jcam, pcam = cameras()
  return (JaxDirectBA(jcfg, jcam, jcam),
          PortDirectBA(pcfg, pcam, pcam, device="cpu"))


def plane_keyframe(seed=0, textured=True):
  """A preprocessed keyframe of the plane scene as numpy arrays (depth,
  normals, radius_sq, intensity, rgb), by the reference's test-keyframe
  pipeline. The sine intensity holds multiples of 1/255 only, so the
  reference's u8-packed sampling and the port's float sampling read the
  same values."""
  jcam, _ = cameras()
  depth, plane_normals = jsynthetic.make_plane_scene(jcam, seed=seed)
  intensity = jsynthetic.intensity_function_image(jcam) if textured else None
  kf = jsynthetic.preprocess_like_test_keyframe(
      depth, jcam, intensity=intensity, cell=CELL)
  return tuple(np.asarray(x) for x in kf), plane_normals


def perturbed_pose(rng, trans=3e-3, rot=8e-4):
  noise = np.concatenate([rng.uniform(-trans, trans, 3),
                          rng.uniform(-rot, rot, 3)]).astype(np.float32)
  return np.asarray(jse3.exp(jnp.asarray(noise)))


def add_keyframe_both(jba, pba, kf, T, frame_index):
  """Insert one keyframe (numpy arrays) into both back-ends."""
  T = np.asarray(T, np.float32)
  ji = jba.add_keyframe(*(jnp.asarray(x) for x in kf), jnp.asarray(T),
                        frame_index)
  pi = pba.add_keyframe(*(torch.from_numpy(x.copy()) for x in kf),
                        torch.from_numpy(T.copy()), frame_index)
  assert ji == pi
  return ji


def jax_state(jba):
  """(surfels, kf, host_state) of a JAX DirectBA as numpy."""
  surfels = {k: np.asarray(v) for k, v in jba.surfels._asdict().items()}
  kf = {k: np.asarray(v) for k, v in jba.kf._asdict().items()}
  host = {name: getattr(jba, name) for name in HOST_MIRRORS}
  return surfels, kf, host


def port_from_jax(jba, pcfg=None):
  """The port's DirectBA, on the CPU, continuing from a JAX DirectBA's
  state."""
  if pcfg is None:
    pcfg = PortConfig(**dataclasses.asdict(jba.config))
  _, pcam = cameras()
  surfels, kf, host = jax_state(jba)
  calib = DepthCalibration.from_numpy(
      np.asarray(jba.depth_intr), np.asarray(jba.a), np.asarray(jba.cfactor),
      np.asarray(jba.baseline_fx), jba.cell_size, jba.depth_size, "cpu")
  return PortDirectBA.from_numpy(pcfg, pcam, pcam, surfels, kf, calib, host,
                                 "cpu")


def port_store(store):
  """A port store's fields as numpy."""
  return {k: v.numpy() for k, v in store._asdict().items()}


def assert_stores(jstore, pstore, tolerances=None, skip=(), rtol=0.0):
  """Every field of a JAX store against the port's, dtype and shape
  included: exact unless ``tolerances`` names an absolute tolerance for it
  (to which ``rtol`` times the value adds: the plane scene's steep planes
  reach 180 m, where a float32 ulp is 1.5e-5 m)."""
  tolerances = tolerances or {}
  j = {k: np.asarray(v) for k, v in jstore._asdict().items()}
  p = port_store(pstore)
  assert set(j) == set(p)
  for name in j:
    if name in skip:
      continue
    assert j[name].dtype == p[name].dtype, name
    assert j[name].shape == p[name].shape, name
    if name in tolerances:
      np.testing.assert_allclose(p[name], j[name], rtol=rtol,
                                 atol=tolerances[name], err_msg=name)
    else:
      np.testing.assert_array_equal(p[name], j[name], err_msg=name)
