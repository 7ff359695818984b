"""An office sweep modelled on TUM RGB-D fr1/room: a hand-held RGB-D camera
carried round an ellipse about the centre of a closed room, facing the
walls, at `rate_hz`.

The room is a box room_x_m x room_z_m across and room_height_m high,
centred on the path, its floor eye_height_m below the path's mean height.
`n_points` textured points lie on its four walls, its floor and its
ceiling, spread by area and placed from `scene_seed`, so the same room is
swept in every run.  --seed draws the textures and the background with
synthetic_np's recipe, as worlds/mav_loop.py does.

The path is the ellipse with semi-axes semi_x_m and semi_z_m about the
room's centre, at a constant speed_m_s along it; its height bobs by
bob_m * sin(2 pi t / bob_period_s) (t in seconds from the first frame).
The camera faces outward from the ellipse's centre, toward the walls,
turned on top of that by a yaw sweep of yaw_sweep_deg * sin(2 pi t /
yaw_period_s) and a pitch of pitch_deg * sin(2 pi t / pitch_period_s).

Camera axes as synthetic_np's: x right, y down, z forward; the room's
vertical is its y axis (up is -y).  The world's frame, in which the poses
and points are given, is the first camera's (the first pose is the
identity), as in worlds/circle.py and worlds/mav_loop.py: the engine's
trajectory starts at the identity, so the truth holds its poses in the
frame, and at the magnitudes, in which the program holds its own.
first_pose gives that frame in the room's."""

import dataclasses

import numpy as np

from perfbench import synthetic_np

# Samples of the ellipse's parameter for its arc-length table.
ARC_SAMPLES = 1 << 16


def _rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def perimeter(p: dict) -> float:
    """The ellipse's length (m)."""
    return float(_arc_table(p)[1][-1])


def _arc_table(p: dict) -> tuple[np.ndarray, np.ndarray]:
    """(phi, arc length from phi = 0) over one lap of the ellipse."""
    a, b = float(p["semi_x_m"]), float(p["semi_z_m"])
    phi = np.linspace(0.0, 2 * np.pi, ARC_SAMPLES + 1)
    mid = 0.5 * (phi[1:] + phi[:-1])
    ds = np.hypot(a * np.sin(mid), b * np.cos(mid)) * np.diff(phi)
    return phi, np.concatenate([[0.0], np.cumsum(ds)])


def positions(p: dict, t: np.ndarray) -> np.ndarray:
    """(len(t), 3) camera centres at the times t (s)."""
    a, b = float(p["semi_x_m"]), float(p["semi_z_m"])
    phi_tab, s_tab = _arc_table(p)
    s = np.mod(float(p["speed_m_s"]) * t, s_tab[-1])
    phi = np.interp(s, s_tab, phi_tab)
    height = float(p["bob_m"]) * np.sin(2 * np.pi * t / float(p["bob_period_s"]))
    return np.stack([a * np.cos(phi), -height, b * np.sin(phi)], axis=1)


def room_poses(p: dict) -> np.ndarray:
    """(frames, 4, 4) f64 T_room_cam of the sweep, in the room's frame
    (its centre at the origin)."""
    n = int(p["frames"])
    t = np.arange(n) / float(p["rate_hz"])
    pos = positions(p, t)
    heading = np.arctan2(pos[:, 0], pos[:, 2])  # forward (sin, 0, cos) points outward
    yaw = heading + np.radians(float(p["yaw_sweep_deg"])) * np.sin(
        2 * np.pi * t / float(p["yaw_period_s"]))
    pitch = np.radians(float(p["pitch_deg"])) * np.sin(2 * np.pi * t / float(p["pitch_period_s"]))
    poses = np.zeros((n, 4, 4), np.float64)
    for k in range(n):
        poses[k, :3, :3] = _rot_y(yaw[k]) @ _rot_x(pitch[k])
        poses[k, :3, 3] = pos[k]
        poses[k, 3, 3] = 1.0
    return poses


def first_pose(p: dict) -> np.ndarray:
    """(4, 4) f64 T_room_world: the first camera's pose in the room."""
    return room_poses(dict(p, frames=1))[0]


def _inv(T: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def trajectory(p: dict) -> np.ndarray:
    """(frames, 4, 4) f32 T_world_cam of the sweep, in the first camera's
    frame."""
    return (_inv(first_pose(p)) @ room_poses(p)).astype(np.float32)


def room_points(p: dict) -> np.ndarray:
    """(n_points, 3) f64 points on the room's six faces in the room's
    frame, from scene_seed alone, each face getting points in proportion
    to its area."""
    rng = np.random.default_rng(int(p["scene_seed"]))
    n = int(p["n_points"])
    X, Z, H = float(p["room_x_m"]), float(p["room_z_m"]), float(p["room_height_m"])
    floor = float(p["eye_height_m"])  # y grows downward
    top = floor - H
    # (area, fixed axis, its value) of each face: the walls x = +-X/2 and
    # z = +-Z/2, the floor and the ceiling.
    faces = [(Z * H, 0, -X / 2), (Z * H, 0, X / 2), (X * H, 2, -Z / 2), (X * H, 2, Z / 2),
             (X * Z, 1, floor), (X * Z, 1, top)]
    area = np.array([f[0] for f in faces])
    face = rng.choice(len(faces), size=n, p=area / area.sum())
    pts = np.stack([rng.uniform(-X / 2, X / 2, n), rng.uniform(top, floor, n),
                    rng.uniform(-Z / 2, Z / 2, n)], axis=1)
    for i, (_, axis, val) in enumerate(faces):
        pts[face == i, axis] = val
    return pts


def _scene(p: dict) -> np.ndarray:
    """(n_points, 3) f32 room_points in the first camera's frame."""
    T = _inv(first_pose(p))
    return (room_points(p) @ T[:3, :3].T + T[:3, 3]).astype(np.float32)


def make_world(traffic, cam: synthetic_np.Camera, seed: int) -> synthetic_np.World:
    p = traffic.params
    poses = trajectory(p)
    # synthetic_np's textures and background from the seed; its own
    # points are replaced by the room's.
    world = synthetic_np.make_world(cam, poses, int(p["n_points"]), int(p["scene_seed"]), seed)
    return dataclasses.replace(world, points_w=_scene(p))
