"""Trajectory evaluation: ATE RMSE with SE(3) or Sim(3) alignment, and RPE.

Port of ``badslam_tpu/eval.py``. The original evaluates its accuracy with
the TUM RGB-D and ETH3D benchmark tools; this module gives the same metrics
in the repository:

  python -m badslam_tpu_torch.eval estimated.txt groundtruth.txt
      [--max_diff 0.02] [--sim3] [--rpe [--rpe_delta N]]

Both files are TUM trajectories (ts tx ty tz qx qy qz qw). Poses are
associated by nearest timestamp within ``max_diff`` and aligned in closed
form (Horn/Umeyama, ``loop/ransac.umeyama_alignment``); the ATE is the RMSE
of the aligned translational errors, the standard protocol. Host numpy in
float64.
"""

from __future__ import annotations

import argparse
import sys
from typing import Tuple

import numpy as np

from badslam_tpu_torch.io.dataset import read_tum_trajectory
from badslam_tpu_torch.loop.ransac import umeyama_alignment


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_diff: float = 0.02
              ) -> Tuple[np.ndarray, np.ndarray]:
  """Greedy nearest-timestamp matching (TUM associate.py semantics): each
  timestamp of ``ts_a`` takes its nearest of ``ts_b`` within ``max_diff``
  unless an earlier one took it."""
  pairs = []
  used_b = set()
  for ia, t in enumerate(ts_a):
    ib = int(np.argmin(np.abs(ts_b - t)))
    if abs(ts_b[ib] - t) <= max_diff and ib not in used_b:
      pairs.append((ia, ib))
      used_b.add(ib)
  if not pairs:
    return np.zeros(0, np.int64), np.zeros(0, np.int64)
  a, b = zip(*pairs)
  return np.asarray(a), np.asarray(b)


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             with_scale: bool = False) -> Tuple[float, np.ndarray]:
  """(rmse, aligned estimated positions) after the SE(3) (or Sim(3))
  alignment of the estimate onto the ground truth."""
  T = umeyama_alignment(est_positions, gt_positions, with_scale=with_scale)
  aligned = est_positions @ T[:3, :3].T + T[:3, 3]
  err = np.linalg.norm(aligned - gt_positions, axis=1)
  return float(np.sqrt(np.mean(err ** 2))), aligned


def evaluate_ate(est_path: str, gt_path: str, max_diff: float = 0.02,
                 with_scale: bool = False) -> dict:
  ts_e, poses_e = read_tum_trajectory(est_path)
  ts_g, poses_g = read_tum_trajectory(gt_path)
  ia, ib = associate(ts_e, ts_g, max_diff)
  if len(ia) < 2:
    raise ValueError("fewer than 2 associated poses")
  pe = poses_e[ia][:, :3, 3]
  pg = poses_g[ib][:, :3, 3]
  rmse, aligned = ate_rmse(pe, pg, with_scale)
  err = np.linalg.norm(aligned - pg, axis=1)
  return {
      "ate_rmse": rmse,
      "ate_mean": float(err.mean()),
      "ate_median": float(np.median(err)),
      "ate_max": float(err.max()),
      "pairs": int(len(ia)),
  }


def rpe(poses_est: np.ndarray, poses_gt: np.ndarray, delta: int = 1
        ) -> Tuple[np.ndarray, np.ndarray]:
  """Relative pose error over a fixed frame delta (TUM evaluate_rpe.py
  semantics, the drift metric): for each i the error motion
  E = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d}). Returns (translational errors
  in m, rotational errors in rad), one entry per i."""
  n = len(poses_est) - delta
  terr = np.empty(n)
  rerr = np.empty(n)
  for i in range(n):
    rel_p = np.linalg.inv(poses_est[i]) @ poses_est[i + delta]
    rel_q = np.linalg.inv(poses_gt[i]) @ poses_gt[i + delta]
    e = np.linalg.inv(rel_q) @ rel_p
    terr[i] = np.linalg.norm(e[:3, 3])
    rerr[i] = np.arccos(np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1, 1))
  return terr, rerr


def evaluate_rpe(est_path: str, gt_path: str, max_diff: float = 0.02,
                 delta: int = 1) -> dict:
  ts_e, poses_e = read_tum_trajectory(est_path)
  ts_g, poses_g = read_tum_trajectory(gt_path)
  ia, ib = associate(ts_e, ts_g, max_diff)
  if len(ia) < delta + 1:
    raise ValueError("fewer than delta+1 associated poses")
  terr, rerr = rpe(poses_e[ia], poses_g[ib], delta)
  return {
      "rpe_trans_rmse": float(np.sqrt(np.mean(terr ** 2))),
      "rpe_trans_mean": float(terr.mean()),
      "rpe_trans_max": float(terr.max()),
      "rpe_rot_rmse_deg": float(np.degrees(np.sqrt(np.mean(rerr ** 2)))),
      "rpe_rot_mean_deg": float(np.degrees(rerr.mean())),
      "rpe_pairs": int(len(terr)),
      "rpe_delta": int(delta),
  }


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description="ATE/RPE evaluation (TUM protocol)")
  p.add_argument("estimated")
  p.add_argument("groundtruth")
  p.add_argument("--max_diff", type=float, default=0.02)
  p.add_argument("--sim3", action="store_true",
                 help="align with Sim(3) instead of SE(3)")
  p.add_argument("--rpe", action="store_true",
                 help="also report relative pose error (drift metric)")
  p.add_argument("--rpe_delta", type=int, default=1,
                 help="frame delta for RPE")
  args = p.parse_args(argv)
  result = evaluate_ate(args.estimated, args.groundtruth, args.max_diff,
                        args.sim3)
  if args.rpe:
    result.update(evaluate_rpe(args.estimated, args.groundtruth,
                               args.max_diff, args.rpe_delta))
  for k, v in result.items():
    print(f"{k}: {v:.6f}" if isinstance(v, float) else f"{k}: {v}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
