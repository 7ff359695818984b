"""The share of the RGB-D front end's keypoints that reach the pose solve
with a depth: the tracker's `depth framepoints` counter (keypoints whose
depth lies in the configuration's window) over its `depth keypoints`
counter (the keypoints the front end detected) in the window, in %.
Nothing is read where the window counted no depth keypoint: a stereo
route, or a program without the counters."""


def read(w):
    n = w.events.get("depth keypoints", 0)
    return 100.0 * w.events.get("depth framepoints", 0) / n if n else None
