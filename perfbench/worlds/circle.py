"""A camera driving `laps` times round a circle of `radius_m` in
`circuit_frames` frames, through `n_points` textured points along it
(synthetic_np.circle_trajectory, synthetic_np.make_world).  The points'
places come from `scene_seed`, the same in every run; --seed draws their
textures and the background, so every seed gives the engine the same
amount of work."""

from perfbench import synthetic_np


def make_world(traffic, cam: synthetic_np.Camera, seed: int) -> synthetic_np.World:
    p = traffic.params
    poses = synthetic_np.circle_trajectory(int(p["circuit_frames"]), float(p["radius_m"]),
                                           float(p["laps"]))
    return synthetic_np.make_world(cam, poses, int(p["n_points"]), int(p["scene_seed"]), seed)
