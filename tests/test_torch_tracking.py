"""The port's tracking (``eval/tracking.py``, ``tools/track.py``,
``tools/track_line_search.py``) against the JAX package's (CPU).

Host numpy in both packages, so ids, centres, ages and MOTA counts are
held bit-equal on seeded sequences. Two repairs are pinned against JAX's
own behaviour: nuScenes labels named by the config's class names (JAX's
``str(label)`` drops every box), and the pose of an info without
``pose`` (Waymo's ``veh_to_global``, the nuScenes calibration chain; JAX
takes the identity).
"""

import os
import pickle
import sys

import numpy as np
import pytest

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, TOOLS)

NUSC_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                           "nusc", "voxelnet",
                           "nusc_centerpoint_voxelnet_dcn.py")


def jax_tracking():
    from partner_tpu.eval import tracking

    return tracking


def port_tracking():
    from partner_tpu_torch.eval import tracking

    return tracking


def sequence(rng, names, n_frames=12, n_obj=9):
    """Per frame a list of tracker inputs: objects moving at constant
    velocity in the global frame, each seen in most frames (a few missed:
    tracks coast), some leaving for good after frame 5 (tracks age out),
    a clutter detection of another class beside some, and a low score
    now and then."""
    start = rng.uniform(-30, 30, (n_obj, 2))
    vel = rng.uniform(-3, 3, (n_obj, 2))
    cls = rng.randint(0, len(names), n_obj)
    gone = rng.rand(n_obj) < 0.3
    frames = []
    for f in range(n_frames):
        dets = []
        for j in range(n_obj):
            if (gone[j] and f > 5) or rng.rand() < 0.15:
                continue
            ct = start[j] + vel[j] * f + rng.randn(2) * 0.05
            dets.append({"translation": np.array([ct[0], ct[1], 0.5]),
                         "velocity": vel[j] + rng.randn(2) * 0.05,
                         "detection_name": names[cls[j]],
                         "score": float(rng.uniform(0.05, 1.0))})
            if rng.rand() < 0.2:   # another class on the same spot
                other = names[(cls[j] + 1) % len(names)]
                dets.append(dict(dets[-1], detection_name=other,
                                 score=float(rng.uniform(0.05, 1.0))))
        if f == 7:
            dets = []              # an empty frame ages every track
        frames.append(dets)
    return frames


def track_state(tracks):
    return [(t["tracking_id"], t["age"], t["active"], t["label_preds"],
             t["detection_name"], t["ct"].tolist(), t["tracking"].tolist(),
             np.asarray(t["translation"]).tolist(), t["score"])
            for t in tracks]


def test_greedy_assignment_matches_jax(rng):
    jt, pt = jax_tracking(), port_tracking()
    for n, m in ((0, 3), (4, 0), (5, 5), (7, 3), (3, 9)):
        dist = rng.rand(n, m) * 10
        dist[rng.rand(n, m) < 0.3] += 1e18
        np.testing.assert_array_equal(pt.greedy_assignment(dist),
                                      jt.greedy_assignment(dist))


@pytest.mark.parametrize("kind", ["waymo", "nusc"])
def test_trackers_match_jax(rng, kind):
    """Gates, class mismatch, coasting, ageing and the score threshold over
    three seeded sequences: every frame's active tracks and every kept
    track's state bit-equal."""
    jt, pt = jax_tracking(), port_tracking()
    names = (jt.WAYMO_TRACKING_NAMES if kind == "waymo"
             else jt.NUSC_TRACKING_NAMES)
    assert names == (pt.WAYMO_TRACKING_NAMES if kind == "waymo"
                     else pt.NUSC_TRACKING_NAMES)
    make = "waymo_tracker" if kind == "waymo" else "nusc_tracker"
    for seed in range(3):
        seq = sequence(np.random.RandomState(seed), names)
        jtr = getattr(jt, make)(score_thresh=0.3)
        ptr = getattr(pt, make)(score_thresh=0.3)
        n_active = 0
        for dets in seq:
            jout = jtr.step([dict(d) for d in dets], 1.0)
            pout = ptr.step([dict(d) for d in dets], 1.0)
            assert track_state(pout) == track_state(jout)
            assert track_state(ptr.tracks) == track_state(jtr.tracks)
            n_active += len(pout)
        assert ptr.id_count == jtr.id_count > 3
        assert n_active > 30


def detections_and_infos(rng, n_frames=6, n_obj=5, labels=3, pose=True):
    """A prediction dict and its infos: boxes moving in the global frame,
    seen from an ego pose that turns and drives (9-column boxes with
    velocity in the lidar frame)."""
    start = rng.uniform(-20, 20, (n_obj, 2))
    vel = rng.uniform(-2, 2, (n_obj, 2))
    lab = rng.randint(0, labels, n_obj)
    dets, infos = {}, []
    for f in range(n_frames):
        yaw = 0.05 * f
        c, s = np.cos(yaw), np.sin(yaw)
        ego = np.eye(4)
        ego[:2, :2] = [[c, -s], [s, c]]
        ego[:3, 3] = [3.0 * f, 0.5 * f, 0.1]
        inv = np.linalg.inv(ego)
        glob = np.concatenate([start + vel * f, np.ones((n_obj, 1)),
                               np.ones((n_obj, 1))], 1)
        local = (inv @ glob.T).T[:, :3]
        boxes = np.zeros((n_obj, 9), np.float32)
        boxes[:, :3] = local
        boxes[:, 3:6] = [4.0, 2.0, 1.6]
        boxes[:, 6:8] = vel @ inv[:2, :2].T
        boxes[:, 8] = rng.uniform(-np.pi, np.pi, n_obj)
        tok = f"seq_0_frame_{f}"
        dets[tok] = {"box3d_lidar": boxes,
                     "scores": rng.uniform(0.5, 1.0, n_obj).astype(
                         np.float32),
                     "label_preds": lab.copy()}
        info = {"token": tok, "timestamp": float(f)}
        if pose:
            info["pose"] = ego
        infos.append(info)
    return dets, infos


def same_frames(got, want):
    assert [f["token"] for f in got] == [f["token"] for f in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_convert_detection_to_global_box_matches_jax(rng):
    jt, pt = jax_tracking(), port_tracking()
    dets, infos = detections_and_infos(rng)
    dets["seq_0_frame_2"]["box3d_lidar"] = np.zeros((0, 9), np.float32)
    dets["seq_0_frame_3"]["box3d_lidar"] = dets["seq_0_frame_3"][
        "box3d_lidar"][:, [0, 1, 2, 3, 4, 5, 8]]   # 7 columns: no velocity
    # out of timestamp order on input
    dets = dict(reversed(list(dets.items())))
    same_frames(pt.convert_detection_to_global_box(dets, infos),
                jt.convert_detection_to_global_box(dets, infos))


def result_equal(got, want):
    assert list(got) == list(want)
    for tok in want:
        assert sorted(got[tok]) == sorted(want[tok])
        for k in want[tok]:
            np.testing.assert_array_equal(got[tok][k], want[tok][k],
                                          err_msg=f"{tok} {k}")
            assert got[tok][k].dtype == want[tok][k].dtype


def test_waymo_run_tracking_matches_jax(rng):
    import track

    from partner_tpu_torch.tools import track as ptrack

    dets, infos = detections_and_infos(rng, n_frames=8, n_obj=7, labels=4)
    # a second sequence, its frames interleaved with the first's
    more, more_infos = detections_and_infos(np.random.RandomState(5))
    for (tok, d), info in zip(more.items(), more_infos):
        new = tok.replace("seq_0", "seq_1")
        dets[new] = d
        infos.append(dict(info, token=new, timestamp=info["timestamp"] + .5))
    for kw in ({}, {"score_thresh": 0.7, "max_age": 1},
               {"max_dist": {"VEHICLE": 1.0, "PEDESTRIAN": 0.4,
                             "CYCLIST": 0.6}}):
        want = track.run_tracking(dets, infos, dataset="waymo", **kw)
        got = ptrack.run_tracking(dets, infos, dataset="waymo", **kw)
        result_equal(got, want)
        assert sum(len(r["tracking_ids"]) for r in got.values()) > 20


def jax_nusc_with_names(dets, infos, class_names):
    """JAX's tracker driven as its run_tracking drives it, each label
    named by the config's class names in place of ``str(label)``."""
    jt = jax_tracking()
    out = {}
    tracker = jt.nusc_tracker()
    last_t = None
    for fr in jt.convert_detection_to_global_box(dets, infos):
        time_lag = 0.0 if last_t is None else float(fr["timestamp"] - last_t)
        last_t = fr["timestamp"]
        tracks = tracker.step([
            {"translation": fr["global_boxes"][i],
             "velocity": fr["velocity"][i],
             "detection_name": class_names[int(fr["label_preds"][i])],
             "score": float(fr["scores"][i])}
            for i in range(len(fr["scores"]))], time_lag)
        out[fr["token"]] = {
            "tracking_ids": np.asarray([t["tracking_id"] for t in tracks],
                                       np.int64),
            "boxes_global": np.asarray([t["translation"] for t in tracks],
                                       np.float32).reshape(-1, 3),
            "scores": np.asarray([t["score"] for t in tracks], np.float32),
            "labels": np.asarray([t["label_preds"] for t in tracks],
                                 np.int64)}
    return out


def nusc_inputs(rng):
    """nuScenes-like detections (labels over the config's 10 classes) with
    scene tokens (no ``_frame_``: one sequence)."""
    from partner_tpu_torch.tools.track import class_names_of

    names = class_names_of(NUSC_CONFIG)
    dets, infos = detections_and_infos(rng, n_frames=6, n_obj=12,
                                       labels=len(names))
    rename = {t: f"sample{i:02d}" for i, t in enumerate(dets)}
    dets = {rename[t]: d for t, d in dets.items()}
    infos = [dict(i, token=rename[i["token"]]) for i in infos]
    return names, dets, infos


def test_nusc_tracking_names_labels_by_the_config(rng):
    """The port names each label by the config's class names, as the
    results writer does: its tracks equal JAX's GreedyTracker fed those
    names. JAX's own tool names them ``str(label)``, and its name gate
    drops every box."""
    import track

    from partner_tpu_torch.tools import track as ptrack

    names, dets, infos = nusc_inputs(rng)
    got = ptrack.run_tracking(dets, infos, dataset="nusc",
                              class_names=names)
    result_equal(got, jax_nusc_with_names(dets, infos, names))
    tracked = sum(len(r["tracking_ids"]) for r in got.values())
    # the tracker's 7 classes of the config's 10
    assert tracked > 20
    jax_out = track.run_tracking(dets, infos, dataset="nusc")
    assert len(jax_out) == len(dets)
    assert sum(len(r["tracking_ids"]) for r in jax_out.values()) == 0
    with pytest.raises(ValueError, match="class_names"):
        ptrack.run_tracking(dets, infos, dataset="nusc")


def test_pose_without_a_pose_key(rng, tmp_path):
    """An info without ``pose``: Waymo's ``veh_to_global`` from the anno
    pickle, or the nuScenes lidar -> ego -> global chain of the results
    writer; the port's frames then equal JAX's fed that pose. JAX alone
    takes the identity; an info with none of them raises naming
    ``pose``."""
    from partner_tpu_torch.eval.nuscenes import _box_to_global

    jt, pt = jax_tracking(), port_tracking()
    dets, infos = detections_and_infos(rng)
    bare = []
    for i, info in enumerate(infos):
        path = str(tmp_path / f"anno{i}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"veh_to_global": info["pose"].ravel(),
                         "objects": []}, f)
        bare.append({"token": info["token"], "timestamp": info["timestamp"],
                     "anno_path": path})
    same_frames(pt.convert_detection_to_global_box(dets, bare),
                jt.convert_detection_to_global_box(dets, infos))
    # JAX on the bare infos tracks in the sensor frame
    ident = jt.convert_detection_to_global_box(dets, bare)
    np.testing.assert_array_equal(
        ident[1]["global_boxes"], dets[ident[1]["token"]]["box3d_lidar"][
            :, :3])

    calib = []
    for info in bare:
        q1 = rng.randn(4)
        q2 = np.array([np.cos(0.3), 0, 0, np.sin(0.3)])
        calib.append({"token": info["token"],
                      "timestamp": info["timestamp"],
                      "lidar2ego_rotation": q1 / np.linalg.norm(q1),
                      "lidar2ego_translation": rng.randn(3),
                      "ego2global_rotation": q2,
                      "ego2global_translation": rng.randn(3) * 100})
    got = pt.convert_detection_to_global_box(dets, calib)
    with_pose = [dict(c, pose=pt.frame_pose(c)) for c in calib]
    same_frames(got, jt.convert_detection_to_global_box(dets, with_pose))
    by_tok = {c["token"]: c for c in calib}
    for fr in got:
        boxes = dets[fr["token"]]["box3d_lidar"]
        for i in range(len(boxes)):
            center, _, vel = _box_to_global(
                boxes[i, :3].astype(np.float64), np.array([1.0, 0, 0, 0]),
                np.array([boxes[i, 6], boxes[i, 7], 0.0]),
                by_tok[fr["token"]])
            # the chain as a matrix: within float64 rounding of the writer
            np.testing.assert_allclose(fr["global_boxes"][i], center,
                                       rtol=0, atol=1e-9)
            np.testing.assert_allclose(fr["velocity"][i], vel[:2], rtol=0,
                                       atol=1e-9)

    nothing = [{"token": i["token"], "timestamp": i["timestamp"]}
               for i in infos]
    with pytest.raises(KeyError, match="pose"):
        pt.convert_detection_to_global_box(dets, nothing)


def test_mota_evaluate_matches_jax(rng):
    """CLEAR-MOT counts over tracked output, with misses, false positives,
    a class mismatch and two same-class objects that cross (their
    tracker ids swap): every count bit-equal."""
    jt, pt = jax_tracking(), port_tracking()
    gt, res = {}, {}
    for f in range(10):
        tok = f"t{f}"
        centers = np.array([[0.0 + f, 0, 0], [10 - f * 1.0, 0.3, 0],
                            [20, 20, 0], [-5, 5 + f, 0]], np.float32)
        gt[tok] = {"centers": centers, "labels": np.array([0, 0, 1, 2]),
                   "ids": np.array([11, 12, 13, 14])}
        # the first two cross at f = 5; past it their tracker ids swap
        ids = [1, 2, 3, 4] if f < 7 else [2, 1, 3, 4]
        keep = [j for j in range(4) if rng.rand() > 0.15]
        boxes = centers[keep] + rng.randn(len(keep), 3).astype(
            np.float32) * 0.1
        labels = np.array([0, 0, 1, 2])[keep]
        if f == 3:
            labels = labels.copy()
            labels[-1] = 1                  # a class mismatch
        extra = rng.uniform(-40, 40, (1, 3)).astype(np.float32)
        res[tok] = {"tracking_ids": np.array([ids[j] for j in keep] + [99]),
                    "boxes_global": np.concatenate([boxes, extra]),
                    "labels": np.concatenate([labels, [0]])}
    res["t4"] = {"tracking_ids": np.zeros(0, np.int64),
                 "boxes_global": np.zeros((0, 3), np.float32),
                 "labels": np.zeros(0, np.int64)}
    del res["t9"]
    want = jt.mota_evaluate(res, gt)
    assert pt.mota_evaluate(res, gt) == want
    assert want["id_switches"] > 0 and want["misses"] > 0
    assert want["false_positives"] > 0
    for d in (0.5, 5.0):
        assert pt.mota_evaluate(res, gt, max_match_dist=d) == \
            jt.mota_evaluate(res, gt, max_match_dist=d)


def test_line_search_gates():
    """Waymo: JAX's vehicle gate with pedestrian x 0.4 and cyclist x 0.6.
    nuScenes: each class's default gate scaled by dist / 4 (the car's),
    where JAX hands the Waymo keys to the nuScenes tracker, a KeyError
    once the names are mapped."""
    from partner_tpu_torch.eval.tracking import NUSC_CLS_VELOCITY_ERROR
    from partner_tpu_torch.tools.track_line_search import gates

    assert gates("waymo", 2.0) == {"VEHICLE": 2.0, "PEDESTRIAN": 0.8,
                                   "CYCLIST": 1.2}
    g = gates("nusc", 2.0)
    assert g == {c: 2.0 * d / 4 for c, d in NUSC_CLS_VELOCITY_ERROR.items()}
    assert g["car"] == 2.0 and g["bus"] == 2.75 and g["pedestrian"] == 0.5
    assert gates("nusc", 4.0) == NUSC_CLS_VELOCITY_ERROR
    jt = jax_tracking()
    tracker = jt.nusc_tracker(max_dist={"VEHICLE": 2.0, "PEDESTRIAN": 0.8,
                                        "CYCLIST": 1.2})
    with pytest.raises(KeyError):
        tracker.step([{"translation": np.zeros(3), "velocity": np.zeros(2),
                       "detection_name": "car", "score": 0.9}], 0.0)


def write(tmp_path, name, obj):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return path


def test_cli_tools(rng, tmp_path):
    """``track`` writes the results and the Waymo tracking bin; ``--dataset
    nusc`` without ``--config`` exits non-zero; ``track_line_search`` finds
    MOTA 1.0 over ground truth fed as detections, on Waymo and on nuScenes
    with its per-class gates."""
    from partner_tpu_torch.tools import track as ptrack
    from partner_tpu_torch.tools import track_line_search as pls

    dets, infos = detections_and_infos(rng, labels=3)
    pred, info_p = write(tmp_path, "pred.pkl", dets), write(
        tmp_path, "infos.pkl", infos)
    out = tmp_path / "out"
    res = ptrack.main(["--prediction", pred, "--info_path", info_p,
                       "--work_dir", str(out)])
    with open(out / "tracking_result.pkl", "rb") as f:
        result_equal(pickle.load(f), res)
    assert (out / "tracking_pred.bin").stat().st_size > 0
    with pytest.raises(SystemExit) as e:
        ptrack.main(["--prediction", pred, "--info_path", info_p,
                     "--dataset", "nusc"])
    assert e.value.code not in (0, None)

    for dataset, labels in (("waymo", 3), ("nusc", None)):
        if dataset == "nusc":
            names, dets, infos = nusc_inputs(rng)
            keep = [i for i, n in enumerate(names)
                    if n in port_tracking().NUSC_TRACKING_NAMES]
            for d in dets.values():
                d["label_preds"] = np.asarray(keep)[
                    d["label_preds"] % len(keep)]
        else:
            dets, infos = detections_and_infos(rng, labels=labels)
        pt = port_tracking()
        frames = pt.convert_detection_to_global_box(dets, infos)
        # ground truth labels in the tracker's label space: the index of
        # the class among its tracking names
        tracked = (pt.WAYMO_TRACKING_NAMES if dataset == "waymo"
                   else pt.NUSC_TRACKING_NAMES)
        label_names = tracked if dataset == "waymo" else names
        gt = {fr["token"]: {
            "centers": fr["global_boxes"],
            "labels": np.array([tracked.index(label_names[l])
                                for l in fr["label_preds"]]),
            "ids": np.arange(len(fr["scores"]))} for fr in frames}
        argv = ["--prediction", write(tmp_path, "p.pkl", dets),
                "--info_path", write(tmp_path, "i.pkl", infos),
                "--gt_path", write(tmp_path, "g.pkl", gt),
                "--scores", "0.3:0.6:0.3", "--dists", "1.0:3.0:2.0",
                "--dataset", dataset]
        if dataset == "nusc":
            argv += ["--config", NUSC_CONFIG]
        best = pls.main(argv)
        assert best[0] == 1.0 and best[3]["id_switches"] == 0, (dataset,
                                                                  best)
