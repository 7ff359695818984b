"""SlamEngine: system orchestration (port of vslam_tpu/system/engine.py).

Wires the per-frame tracker (stereo or RGB-D), the world map (local
maps), the Hamming database relocalizer, landmark merging, the
hierarchical pose graph and windowed bundle adjustment;
owns the per-frame loop, the trajectory and the end-of-run report
(printReport parity, slam_assembly.cpp:622-744).

With the fused tracker (the default), keyframe snapshots are taken inside
the per-frame device step and arrive as events at the tracker's drains
(every frame on the CPU, every parallelism.frames_per_chunk frames on
CUDA).  Closure work is pipelined
across drains as in the JAX engine: a drain's new local maps dispatch one
query+insert program; their results are read at the next drain, voted
on, and the survivors' ICP dispatched; the ICP verdicts are read at the
drain after that and become closures — pose-graph optimization, rigid
back-propagation of the corrections, landmark merging.  flush() resolves
until nothing is in flight.  With the modular PoseTracker
(tracking.use_fused_tracker: false) the engine triggers keyframes on the
host after every frame and queries, verifies and applies each closure at
once (_synchronous_keyframe_path).  Open loop
(command_line.option_disable_relocalization) only fills the database.
Under a torch.distributed process group every rank runs the engine on
the same frames; the database search and the windowed BA are then
row-sharded over the ranks (parallel/).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from vslam_tpu_torch.backend import pose_graph as pg
from vslam_tpu_torch.io.config import ParameterCollection
from vslam_tpu_torch.loop.relocalizer import Relocalizer
from vslam_tpu_torch.mapping import landmarks as lm_mod
from vslam_tpu_torch.mapping import merging
from vslam_tpu_torch.system import ba_runner
from vslam_tpu_torch.mapping.local_maps import WorldMap
from vslam_tpu_torch.ops import camera as cam_ops
from vslam_tpu_torch.parallel import mesh as mesh_mod
from vslam_tpu_torch.tracking import fused
from vslam_tpu_torch.tracking.tracker import FusedPoseTracker, KeyframeSnapshot, PoseTracker
from vslam_tpu_torch.utils import log
from vslam_tpu_torch.utils.device import DEFAULT_DEVICE

# Odometry edges spanning a tracking break carry ~no information: the pose
# graph, not the dead-reckoned edge, reattaches the map after a closure.
BREAK_EDGE_WEIGHT = 1e-3
# Left images kept for keyframe overlays: keyframe events lag the frames
# by up to one drain.
VIZ_RING_FRAMES = 128


def _check_supported(cfg: ParameterCollection) -> None:
    if (cfg.graph_optimization.enable_full_bundle_adjustment
            and cfg.command_line.tracker_mode == "RGB_DEPTH"):
        # The JAX engine runs this pair against wrong residuals: its
        # keyframe observations are [u, v, z, 0] in RGB-D mode, and BA
        # reads them as stereo [uL, vL, uR, vR].
        raise ValueError(
            "enable_full_bundle_adjustment with tracker_mode RGB_DEPTH: bundle "
            "adjustment reads keyframe observations as stereo [uL, vL, uR, vR], "
            "but RGB-D keyframes hold [u, v, depth, 0]")


class SlamEngine:
    def __init__(self, cam: cam_ops.CameraParams,
                 config: ParameterCollection | None = None,
                 landmark_capacity: int = 65536, device=DEFAULT_DEVICE):
        self.cfg = config or ParameterCollection()
        self.cfg.validate()
        _check_supported(self.cfg)
        self.fused = self.cfg.tracking.use_fused_tracker
        tracker_cls = FusedPoseTracker if self.fused else PoseTracker
        self.tracker = tracker_cls(cam, self.cfg, landmark_capacity, device=device)
        self.cam = self.tracker.cam
        self.device = self.tracker.device
        wm = self.cfg.world_map
        self.world_map = WorldMap(
            min_distance=wm.minimum_distance_traveled_for_local_map,
            min_degrees=wm.minimum_degrees_rotated_for_local_map,
            min_frames=wm.minimum_number_of_frames_for_local_map,
        )
        # Under an initialized torch.distributed process group of more than
        # one rank every rank runs this engine on the same frames (SPMD),
        # and the database search and the windowed BA shard their rows over
        # the ranks (parallel/); mesh_shape (1,) takes every rank, a larger
        # shape caps the count, as in the JAX engine.
        par = self.cfg.parallelism
        mesh = None
        if par.shard_descriptor_db or par.shard_landmarks:
            n_mesh = int(np.prod(par.mesh_shape))
            mesh = mesh_mod.make_mesh(None if n_mesh <= 1 else n_mesh)
        self.mesh = mesh
        self.landmark_mesh = mesh if par.shard_landmarks else None
        # One query row per snapshot row: the snapshot width (the modular
        # path caps its snapshots at local_map.maximum_number_of_landmarks).
        # Only the fused tracker has a snapshot archive for closure ICP;
        # the modular path's ICP takes the local maps' host blocks.
        self.relocalizer = Relocalizer(
            self.cfg.relocalization,
            query_cap=(self.tracker.state.kf_desc.shape[1] if self.fused
                       else self.cfg.local_map.maximum_number_of_landmarks),
            device=self.device, mesh=mesh if par.shard_descriptor_db else None)
        if self.fused:
            self.relocalizer.ring_provider = self._ring_provider
        self.open_loop = self.cfg.command_line.option_disable_relocalization
        # Pose-graph bookkeeping: one vertex per local-map keyframe.
        self.kf_poses: list[np.ndarray] = []
        self.kf_frame_indices: list[int] = []
        self.kf_odometry: list[np.ndarray] = []  # T_{k-1,k} measured
        self.kf_odom_weight: list[float] = []  # breakTrack-aware edge weights
        self.closure_edges: list[tuple[int, int, np.ndarray]] = []
        self._breaks_consumed = 0
        # Closure work dispatched at one drain, resolved at the next.
        self._inflight_queries: list = []
        self._inflight_icp: list = []
        self._slot_remap: dict[int, int] = {}  # absorbed -> representative
        self.n_optimizations = 0
        self.n_merges = 0
        self.n_ba_runs = 0
        self._last_ba_frame = 0
        # Snapshots of the current drain not registered yet: a bundle
        # adjustment run while registering an earlier one corrects them.
        self._unregistered: list[KeyframeSnapshot] = []
        # Keyframe image dump (reference ImageViewer as files,
        # image_viewer.cpp:84-155): a bounded ring of recent left images,
        # so a keyframe event can still render its overlay.
        self._viz_enabled = self.cfg.visualization.enable_image_dump
        self._viz_dir = self.cfg.visualization.dump_directory
        self._viz_ring: dict[int, np.ndarray] = {}
        if self._viz_enabled:
            from vslam_tpu_torch.viz import plots

            plots.require_matplotlib()  # fail before the run, not at its first keyframe
            os.makedirs(self._viz_dir, exist_ok=True)
        self._t_start = time.perf_counter()
        self._frame_times: list[float] = []

    def _ring_provider(self):
        """The snapshot archive and its horizon: the newest map id whose
        ring row may have been overwritten.  The bound is taken on the
        device's keyframe count without reading it: at most one keyframe
        fires per frame, so frames dispatched since the last harvest may
        have added that many.  (The JAX engine bounds it by the harvested
        count alone, and on an accelerator a row overwritten by a frame in
        flight would then be gathered as if it were the map's.)"""
        tr = self.tracker
        st = tr.state
        horizon = (tr._kf_harvested + (tr._dispatched - tr._harvested)
                   - st.kf_pose.shape[0])
        return st.kf_pose, st.kf_xyz, horizon

    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                odometry: np.ndarray | None = None) -> np.ndarray:
        """Process one frame (the stereo pair, or the intensity image and
        depth in meters); returns the tracker's last harvested T_world_cam
        (exact per frame on the CPU)."""
        t0 = time.perf_counter()
        if self._viz_enabled:
            idx = self.tracker.n_frames_in
            self._viz_ring[idx] = img_l
            self._viz_ring.pop(idx - VIZ_RING_FRAMES - 1, None)
        T = self.tracker.compute(img_l, img_r, odometry)
        if self.fused:
            self._consume_keyframe_events()
        else:
            self._synchronous_keyframe_path()
        self._frame_times.append(time.perf_counter() - t0)
        return T

    def process_prestaged(self, staged) -> np.ndarray:
        """Dataset playback: step one handle of tracker.prestage(); keyframe
        events and closure work follow the drains exactly as in process()."""
        if not self.fused:
            raise ValueError("process_prestaged needs the fused tracker "
                             "(tracking.use_fused_tracker: true); the modular "
                             "PoseTracker takes frames through process()")
        t0 = time.perf_counter()
        T = self.tracker.compute_prestaged(staged)
        self._consume_keyframe_events()
        self._frame_times.append(time.perf_counter() - t0)
        return T

    def _flush_tracker(self):
        """Drain the tracker and the closure pipeline to empty (the modular
        path has nothing in flight)."""
        if not self.fused:
            return
        self.tracker.flush()
        self._consume_keyframe_events()
        while self._inflight_queries or self._inflight_icp:
            self._resolve_inflight()

    def _consume_keyframe_events(self):
        """Register every harvested snapshot, resolve the closure work of
        the previous drain, then dispatch the new local maps' query (one
        query+insert program).  Corrections from closures resolved here
        are global, so registering the snapshots first is exact."""
        self._unregistered = self.tracker.pop_keyframes()
        local_maps = []
        while self._unregistered:
            local_maps.append(self._register_keyframe(self._unregistered.pop(0)))
        if local_maps:
            # The descriptors stay on the device: gather the batch's
            # snapshot rows there for the relocalizer.
            rows = torch.tensor([m.ring_row for m in local_maps], dtype=torch.int64,
                                device=self.device)
            desc = fused.gather_kf_desc(self.tracker.state.kf_desc, rows,
                                        out_cap=self.relocalizer.QUERY_CAP)
            for i, m in enumerate(local_maps):
                m.desc_dev = desc[i]
        if self.tracker.take_drained():
            self._resolve_inflight()
        if not local_maps:
            return
        if self.open_loop:
            for m in local_maps:
                self.relocalizer.add_local_map(m)
            return
        with log.measure("relocalization"):
            handles = self.relocalizer.submit_batch(local_maps)
            self._inflight_queries.extend(h for h in handles if h is not None)

    def _resolve_inflight(self):
        """Resolve the in-flight work in one device-to-host copy: ICP
        verdicts become closures; fetched queries are voted on and their
        survivors' ICP dispatched (resolved next time).  Then record every
        closure, optimize once if any disagrees with the current estimate
        (residual gate), and merge all their landmark pairs in one pass —
        merging after optimizing, as the reference does (world_map.cpp:305)."""
        queries, icps = self._inflight_queries, self._inflight_icp
        if not queries and not icps:
            return
        self._inflight_queries, self._inflight_icp = [], []
        rel = self.relocalizer
        closures = []
        with log.measure("relocalization"):
            rel.fetch(queries, [j.batch for j in icps])
            for job in icps:  # older work first
                closure = rel.finish_icp(job, rel.job_result(job))
                if closure is not None:
                    closures.append(closure)
            with log.measure("reloc_vote_icp"):
                self._inflight_icp.extend(rel.dispatch_icp_batch([rel.vote(h) for h in queries]))
        new_edges, all_corr = [], []
        for closure in closures:
            new_edges.append(self._record_closure(closure))
            if len(closure.correspondences):
                all_corr.append(np.asarray(closure.correspondences))
        if closures and self._closures_need_optimization(new_edges):
            with log.measure("pose_graph_optimization"):
                self._optimize_pose_graph()
        if all_corr:
            with log.measure("landmark_merging"):
                self._merge_correspondences(np.concatenate(all_corr))

    def _synchronous_keyframe_path(self):
        """The modular tracker's host-side keyframe trigger
        (world_map.cpp:108-111): snapshot the live frame's landmark-backed
        points, at most local_map.maximum_number_of_landmarks of them."""
        tracker = self.tracker
        T = tracker.T_world_cam
        if not self.world_map.should_create_local_map(T):
            return
        # The trigger window restarts whether or not a local map forms;
        # else it re-fires every frame while landmarks are too few.
        self.world_map.note_trigger(T)
        frame = tracker.prev_frame
        if frame is None:
            return
        slots = frame.landmark_slot.cpu().numpy()
        sel = frame.valid.cpu().numpy() & (slots >= 0)
        if sel.sum() < self.cfg.local_map.minimum_number_of_landmarks:
            return
        rows = np.flatnonzero(sel)[:self.cfg.local_map.maximum_number_of_landmarks]
        lm_slots = slots[rows]
        idx = torch.from_numpy(lm_slots.astype(np.int64)).to(self.device)
        snap = KeyframeSnapshot(
            map_id=len(self.world_map.local_maps),
            frame_idx=tracker.frame_idx - 1,
            T_world_kf=T.copy(),
            slots=lm_slots,
            xyz_w=tracker.table.xyz_w[idx].cpu().numpy(),
            desc=tracker.table.desc[idx].cpu().numpy(),
            uv4=frame.uv4[torch.from_numpy(rows).to(self.device)].cpu().numpy(),
        )
        tracker.kf_count = snap.map_id + 1
        self._handle_keyframe(snap)

    def _handle_keyframe(self, snap: KeyframeSnapshot):
        """Register the snapshot, then query, verify and apply its closure
        at once."""
        local_map = self._register_keyframe(snap)
        if self.open_loop:
            self.relocalizer.add_local_map(local_map)
            return
        with log.measure("relocalization"):
            closure = self.relocalizer.resolve(self.relocalizer.submit(local_map))
        if closure is not None:
            self._apply_closure(closure)

    def _apply_closure(self, closure):
        """Record one closure, optimize if it disagrees with the estimate,
        merge its landmark pairs (the pipelined path batches the three a
        drain)."""
        edge = self._record_closure(closure)
        if self._closures_need_optimization([edge]):
            with log.measure("pose_graph_optimization"):
                self._optimize_pose_graph()
        if len(closure.correspondences):
            with log.measure("landmark_merging"):
                self._merge_correspondences(np.asarray(closure.correspondences))

    def _register_keyframe(self, snap: KeyframeSnapshot):
        """Local-map creation + pose-graph vertex/odometry bookkeeping for
        one keyframe event; returns the new LocalMap."""
        if snap.map_id != len(self.world_map.local_maps):
            raise RuntimeError(
                f"keyframe {snap.map_id} out of order "
                f"({len(self.world_map.local_maps)} local maps)")
        local_map = self.world_map.create_local_map(
            snap.T_world_kf, snap.frame_idx, snap.slots, snap.xyz_w, snap.desc,
            uv4=snap.uv4,
        )
        local_map.ring_row = snap.ring_row
        self.kf_poses.append(snap.T_world_kf.copy())
        self.kf_frame_indices.append(snap.frame_idx)
        if len(self.kf_poses) > 1:
            self.kf_odometry.append(np.linalg.inv(self.kf_poses[-2]) @ self.kf_poses[-1])
            prev_fidx = self.kf_frame_indices[-2]
            breaks = self.tracker._break_frames
            spans_break = any(prev_fidx < b <= snap.frame_idx
                              for b in breaks[self._breaks_consumed:])
            self._breaks_consumed = len(breaks)
            self.kf_odom_weight.append(BREAK_EDGE_WEIGHT if spans_break else 1.0)
        if self._viz_enabled:
            self._dump_overlay(snap)
        # Full BA runs on its frame cadence whether or not relocalization
        # is on (slam_assembly.cpp:558-568).
        self._maybe_run_bundle_adjustment(snap)
        return local_map

    def _dump_overlay(self, snap: KeyframeSnapshot):
        """The keyframe's framepoint overlay (image_viewer.cpp:84-155)."""
        img = self._viz_ring.get(snap.frame_idx)
        if img is None or snap.uv4 is None:
            return
        from vslam_tpu_torch.viz import plots

        uv = np.asarray(snap.uv4)[:, :2]
        plots.draw_frame_overlay(
            img, uv, has_landmark=np.asarray(snap.slots) >= 0,
            valid=np.isfinite(uv).all(axis=1),
            path=os.path.join(self._viz_dir, f"overlay_{snap.frame_idx:06d}.png"))

    def _maybe_run_bundle_adjustment(self, snap: KeyframeSnapshot):
        """Windowed BA every number_of_frames_per_bundle_adjustment frames
        (reference optimizeFactorGraph cadence, graph_optimizer.cpp:459)."""
        gopt = self.cfg.graph_optimization
        if (gopt.enable_full_bundle_adjustment and len(self.kf_poses) >= 2
                and snap.frame_idx - self._last_ba_frame
                >= gopt.number_of_frames_per_bundle_adjustment):
            self._last_ba_frame = snap.frame_idx
            with log.measure("bundle_adjustment"):
                self._run_bundle_adjustment()

    def _run_bundle_adjustment(self):
        """Windowed BA over the recent keyframes (system/ba_runner.py).  The
        newest keyframe's correction also moves the snapshots harvested in
        the same drain and not registered yet (on the card a drain holds
        many), as the harvest moves snapshots still in flight."""
        C_last = ba_runner.run_windowed_ba(self)
        if C_last is None:
            return
        self.n_ba_runs += 1
        for s in self._unregistered:
            s.T_world_kf = (C_last @ s.T_world_kf).astype(np.float32)
            s.xyz_w = (s.xyz_w @ C_last[:3, :3].T + C_last[:3, 3]).astype(np.float32)

    def _record_closure(self, closure):
        """World-map bookkeeping + the pose-graph edge (reference, query,
        T_ref_query).  One closure edge per query map (reference
        Relocalizer::prune, relocalizer.cpp:190-224): a re-verified query
        replaces its previous edge."""
        self.world_map.add_closure(closure)
        edge = (closure.reference_id, closure.query_id, closure.T_ref_query)
        for k, (_, qid, _) in enumerate(self.closure_edges):
            if qid == closure.query_id:
                self.closure_edges[k] = edge
                break
        else:
            self.closure_edges.append(edge)
        return edge

    def _closures_need_optimization(self, new_edges) -> bool:
        """Residual gate: optimize only when a new closure disagrees with
        the current estimate by more than the configured bounds."""
        gopt = self.cfg.graph_optimization
        gate_t = gopt.minimum_closure_residual_for_optimization_meters
        gate_r = np.deg2rad(gopt.minimum_closure_residual_for_optimization_degrees)
        if gate_t <= 0.0:
            return True
        for i, j, T_ij in new_edges:
            E = np.linalg.inv(T_ij) @ (np.linalg.inv(self.kf_poses[i]) @ self.kf_poses[j])
            c = np.clip((np.trace(E[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
            if float(np.linalg.norm(E[:3, 3])) > gate_t or float(np.arccos(c)) > gate_r:
                return True
        return False

    def _optimize_pose_graph(self):
        """Hierarchical pose-graph solve, then rigid back-propagation of
        the per-keyframe corrections (graph_optimizer.cpp:411-457)."""
        if len(self.kf_poses) < 3 or not self.closure_edges:
            return None
        gopt = self.cfg.graph_optimization
        # Timed inside as pg_assembly, pg_junction_solve and pg_distribution.
        opt, _ = pg.optimize_pose_graph_hierarchical(
            np.stack(self.kf_poses).astype(np.float32),
            np.stack(self.kf_odometry).astype(np.float32),
            np.asarray(self.kf_odom_weight, np.float32),
            self.closure_edges,
            iterations=gopt.maximum_number_of_iterations,
            robust_kernel_chi2=1.0 if gopt.enable_robust_kernel_for_poses else 1e12,
            closure_bucket=gopt.closure_compaction_bucket,
            levenberg=gopt.optimization_algorithm.upper() in ("LEVENBERG", "DOGLEG"),
            device=self.device,
        )
        with log.measure("pg_propagate"):
            C_last = self._propagate_corrections(opt)
        self.n_optimizations += 1
        return C_last

    def _propagate_corrections(self, opt_poses: np.ndarray) -> np.ndarray:
        """Apply the per-keyframe corrections everywhere: landmarks by
        origin local map, the stored trajectory by owning segment, the
        live pose (and frames in flight) by the last one.  Returns the
        last keyframe's correction."""
        tracker = self.tracker
        n = len(self.kf_poses)
        corrections = np.stack([opt_poses[k] @ np.linalg.inv(self.kf_poses[k])
                                for k in range(n)]).astype(np.float32)
        # Delta gate (minimum_estimation_delta_for_update_meters,
        # graph_optimizer.cpp:430-450): the full matrix-difference norm, so
        # a rotation-only correction above it propagates too.
        gate = self.cfg.graph_optimization.minimum_estimation_delta_for_update_meters
        if gate > 0.0:
            small = np.linalg.norm(corrections - np.eye(4, dtype=np.float32),
                                   axis=(1, 2)) < gate
            if small.any():
                corrections[small] = np.eye(4, dtype=np.float32)
                opt_poses = opt_poses.copy()
                opt_poses[small] = np.stack([self.kf_poses[k] for k in np.flatnonzero(small)])

        tracker.table = lm_mod.apply_kf_corrections(
            tracker.table, torch.from_numpy(corrections).to(self.device))

        # Frame f belongs to the first keyframe with frame index >= f.
        traj = tracker.trajectory
        if traj:
            owner = np.clip(np.searchsorted(np.asarray(self.kf_frame_indices),
                                            np.arange(len(traj)), side="left"), 0, n - 1)
            stacked = np.einsum("fij,fjk->fik", corrections[owner],
                                np.stack(traj).astype(np.float32))
            tracker.trajectory = list(stacked)

        C_last = corrections[-1]
        tracker.apply_world_correction(C_last)
        self.kf_poses = [opt_poses[k].copy() for k in range(n)]
        for k, m in enumerate(self.world_map.local_maps):
            m.T_world_kf = opt_poses[k].copy()
        if self.world_map._last_T is not None:
            self.world_map._last_T = (C_last @ self.world_map._last_T).astype(np.float32)
        return C_last

    def _merge_correspondences(self, corr: np.ndarray):
        """Merge the landmark pairs of one or many closures in one
        union-find + one device pass, then make every slot reference
        follow: the live frame (on the device), the local maps and the
        relocalizer's rows (reference LocalMap::replace,
        local_map.cpp:109-127)."""
        tracker = self.tracker
        # Slots absorbed earlier this run stand for their representative.
        if self._slot_remap and len(corr):
            corr = np.vectorize(lambda s: self._slot_remap.get(int(s), int(s)))(
                corr).astype(np.int32)
            corr = corr[corr[:, 0] != corr[:, 1]]
        table, remap = merging.merge_landmarks(tracker.table, tracker.allocator, corr)
        tracker.table = table
        self.n_merges += len(remap)
        if not remap:
            return
        for k, v in self._slot_remap.items():
            self._slot_remap[k] = remap.get(v, v)
        self._slot_remap.update(remap)
        lut = np.arange(table.capacity, dtype=np.int32)
        for src, dst in remap.items():
            lut[src] = dst
        lut = lut[lut]
        prev = tracker.prev_frame
        if prev is not None:
            lut_dev = torch.from_numpy(lut).to(self.device)
            slots = prev.landmark_slot
            slots = torch.where(slots >= 0,
                                lut_dev[torch.clamp(slots, min=0).to(torch.int64)], slots)
            tracker.prev_frame = prev._replace(landmark_slot=slots)
        for m in self.world_map.local_maps:
            pos = m.landmark_slots >= 0
            m.landmark_slots = m.landmark_slots.copy()
            m.landmark_slots[pos] = lut[m.landmark_slots[pos]]
        self.relocalizer.apply_remap(remap, lut=lut)

    @property
    def trajectory(self) -> np.ndarray:
        self._flush_tracker()
        return np.stack(self.tracker.trajectory)

    def report_lite(self) -> dict:
        """Status-line statistics without draining the device pipeline
        (values lag by up to one drain)."""
        ft = np.asarray(self._frame_times) if self._frame_times else np.zeros(1)
        stats = self.tracker.stats
        return {
            "total_frames": stats.n_frames,
            "mean_frame_hz": round(float(1.0 / max(ft.mean(), 1e-9)), 2),
            "n_landmarks": stats.n_spawned,
            "n_local_maps": len(self.world_map),
            "n_closures": len(self.world_map.closures),
            "n_optimizations": self.n_optimizations,
            "n_track_breaks": stats.n_breaks,
        }

    def report(self) -> dict:
        """printReport parity (slam_assembly.cpp:622-744)."""
        self._flush_tracker()
        ft = np.asarray(self._frame_times) if self._frame_times else np.zeros(1)
        stats = self.tracker.stats
        return {
            "total_frames": stats.n_frames,
            "total_compute_time_s": round(float(ft.sum()), 3),
            "mean_frame_time_s": round(float(ft.mean()), 4),
            "mean_frame_hz": round(float(1.0 / max(ft.mean(), 1e-9)), 2),
            "median_frame_time_s": round(float(np.median(ft)), 4),
            "max_frame_time_s": round(float(ft.max()), 4),
            "wall_time_s": round(time.perf_counter() - self._t_start, 3),
            "n_landmarks": self.tracker.allocator.num_allocated,
            "n_local_maps": len(self.world_map),
            "n_closures": len(self.world_map.closures),
            "n_optimizations": self.n_optimizations,
            "n_ba_runs": self.n_ba_runs,
            "n_merged_landmarks": self.n_merges,
            "n_track_breaks": stats.n_breaks,
            "n_recovered_landmarks": stats.n_recovered,
            # fused.FrameProgram's route ("graph" on the card), or the
            # modular tracker's host-driven step.
            "tracker_step": getattr(self.tracker, "step_route", "modular (host-driven)"),
            "stage_seconds": {k: round(v, 3) for k, v in stats.stage_seconds.items()},
            # The reference's relative/absolute per-module table
            # (slam_assembly.cpp:705-742), fed by utils.log chronometers.
            "stage_table": log.chronometers.report(),
        }

    def print_report(self):
        rep = self.report()
        print("-" * 60)
        print("vslam_tpu_torch run report")
        for k, v in rep.items():
            print(f"  {k:26s} {v}")
        print("-" * 60)
