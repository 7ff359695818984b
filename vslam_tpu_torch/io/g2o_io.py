"""g2o text-format pose-graph and factor-graph export/import (port of
vslam_tpu/io/g2o_io.py; numpy).

Byte-format parity with the reference's writePoseGraphToFile
(src/map_optimization/graph_optimizer.cpp:164-262): VERTEX_SE3:QUAT and
EDGE_SE3:QUAT records, so the exported graph is consumable by stock g2o
tooling and by trajectory_converter (trajectory_converter.cpp:38-89).
The same poses give the JAX package's bytes (quaternions in f32 with an
exact square root, eval/trajectory.py).
"""

from __future__ import annotations

import numpy as np

from vslam_tpu_torch.eval.trajectory import quat_to_rot_f32, rot_to_quat_f32


def _vertex(i: int, T: np.ndarray) -> str:
    qw, qx, qy, qz = rot_to_quat_f32(T[:3, :3])
    t = T[:3, 3]
    return (f"VERTEX_SE3:QUAT {i} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
            f"{qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f}\n")


def _edge(i: int, j: int, T_ij: np.ndarray, info: np.ndarray) -> str:
    qw, qx, qy, qz = rot_to_quat_f32(T_ij[:3, :3])
    t = T_ij[:3, 3]
    return (f"EDGE_SE3:QUAT {i} {j} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
            f"{qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f} " + _upper(info) + "\n")


def _upper(info: np.ndarray) -> str:
    n = info.shape[0]
    return " ".join(f"{info[r, c]:.6f}" for r in range(n) for c in range(r, n))


def write_pose_graph(path: str, poses: np.ndarray, edges: list, fixed: int = 0) -> None:
    """poses (P, 4, 4); edges [(i, j, T_ij (4, 4), info_scale)]."""
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            f.write(_vertex(i, T))
        if len(poses):
            f.write(f"FIX {fixed}\n")
        for (i, j, T_ij, w) in edges:
            f.write(_edge(i, j, T_ij, np.eye(6) * w))


def write_factor_graph(
    path: str,
    poses: np.ndarray,  # (P, 4, 4) keyframe poses (T_world_kf)
    odometry_edges: list,  # [(i, j, T_ij (4,4), weight)]
    landmark_xyz_w: dict,  # landmark slot -> (3,) world position
    observations: list,  # [(kf_idx, slot, p_kf (3,), info_scalar)]
    identifier_space: int = 1_000_000_000,
    base_information_frame: float = 1e4,
    free_translation_for_poses: bool = True,
    base_information_frame_factor_for_translation: float = 1e3,
    fixed: int = 0,
) -> None:
    """Full factor-graph export: pose vertices + odometry edges + landmark
    vertices + pose-landmark measurement edges.

    Landmark vertex ids are offset by `identifier_space` (reference
    parameters.h:362), pose-edge information is base_information_frame*I
    with the translation block scaled when free_translation_for_poses
    (_setPoseEdge, graph_optimizer.cpp:490-507), and point edges carry the
    measurement in the keyframe frame with 1/depth information
    (_setPointEdge, :509-526).  The SE3-offset parameter record is emitted
    so stock g2o loads the EDGE_SE3_TRACKXYZ entries."""
    with open(path, "w") as f:
        f.write("PARAMS_SE3OFFSET 0 0 0 0 0 0 0 1\n")  # G2oParameter::WORLD_OFFSET
        for i, T in enumerate(poses):
            f.write(_vertex(i, T))
        if len(poses):
            f.write(f"FIX {fixed}\n")
        for slot, xyz in sorted(landmark_xyz_w.items()):
            f.write(f"VERTEX_TRACKXYZ {int(slot) + identifier_space} "
                    f"{xyz[0]:.9f} {xyz[1]:.9f} {xyz[2]:.9f}\n")
        info6 = np.eye(6) * base_information_frame
        if free_translation_for_poses:
            info6[:3, :3] *= base_information_frame_factor_for_translation
        for (i, j, T_ij, w) in odometry_edges:
            f.write(_edge(i, j, T_ij, info6 * w))
        for (kf_idx, slot, p_kf, info_scalar) in observations:
            f.write(f"EDGE_SE3_TRACKXYZ {int(kf_idx)} {int(slot) + identifier_space} 0 "
                    f"{p_kf[0]:.9f} {p_kf[1]:.9f} {p_kf[2]:.9f} "
                    + _upper(np.eye(3) * info_scalar) + "\n")


def read_factor_graph(path: str):
    """Round-trip reader for write_factor_graph.  Returns (poses (P,4,4),
    odometry_edges, landmark_xyz_w {gid: (3,)}, observations [(kf, gid,
    p_kf, info)]) — landmark ids are the raw file ids (the caller
    subtracts identifier_space)."""
    poses, edges = read_pose_graph(path)
    landmarks, observations = {}, []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "VERTEX_TRACKXYZ":
                landmarks[int(parts[1])] = np.asarray([float(v) for v in parts[2:5]])
            elif parts[0] == "EDGE_SE3_TRACKXYZ":
                observations.append((int(parts[1]), int(parts[2]),
                                     np.asarray([float(v) for v in parts[4:7]]),
                                     float(parts[7])))
    return poses, edges, landmarks, observations


def _pose(tx, ty, tz, qx, qy, qz, qw) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_rot_f32(np.array([qw, qx, qy, qz]))
    T[:3, 3] = [tx, ty, tz]
    return T


def read_pose_graph(path: str):
    """Returns (poses (P,4,4), edges [(i, j, T_ij, info_scale)])."""
    poses, edges = {}, []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "VERTEX_SE3:QUAT":
                poses[int(parts[1])] = _pose(*map(float, parts[2:9]))
            elif parts[0] == "EDGE_SE3:QUAT":
                edges.append((int(parts[1]), int(parts[2]), _pose(*map(float, parts[3:10])),
                              float(parts[10]) if len(parts) > 10 else 1.0))
    out = np.tile(np.eye(4), (max(poses) + 1 if poses else 0, 1, 1))
    for idx, T in poses.items():
        out[idx] = T
    return out, edges
