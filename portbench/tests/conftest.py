"""Shared helpers of the benchmark's own tests (run them with
``python -m pytest portbench/tests``; the repository's ``pytest tests/``
does not collect them). Tests that need a CUDA device carry the ``cuda``
marker and skip inside the test where none is visible."""

import os
import sys

import pytest
import torch

# Several test workers share the machine's cores: a worker's intra-op
# threads spinning beside another's slow both by orders of magnitude.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

# The tiny size of the CPU rehearsals: a quarter of the cells' 640x480, the
# same field of view.
TINY_CAMERA = dict(width=160, height=120, fx=131.25, fy=131.25, cx=79.5,
                   cy=59.5)


def tiny(cell, session: int = 30):
  """``cell`` at the rehearsal size: 160x120, a session of ``session``
  frames before the window, a sweep of 170 rendered frames past it."""
  cell.config["camera"].update(TINY_CAMERA)
  cell.config["session_frames"] = session
  if not cell.traffic["cyclic"]:
    cell.traffic["rendered_frames"] = session + 170
  return cell


@pytest.fixture
def tiny_cell(monkeypatch):
  """A cell at the rehearsal size, with three profiled frames from the
  window's second on."""
  from portbench.harness import runner, spec
  monkeypatch.setattr(runner, "PROFILE_START_FRAME", 1)
  monkeypatch.setattr(runner, "PROFILE_FRAMES", 3)
  return lambda name, session=30, root=spec.ROOT: tiny(
      spec.load_cell(name, root=root), session)
