"""FastVO, Map2D and SLAM state across the two packages, as numpy.

The system has no weights. Its state is the canvas pyramid (`canvas_lap`,
`canvas_w`: one [H >> i, W >> i, 3] and one [H >> i, W >> i, 1] float32
array per band) and the track carry (previous frame's descriptors — ORB
[N, 256] uint8 bit-planes, SIFT [N, 128] float32 — valid mask [N] bool,
plane points [N, 3] float32, and the two poses [7] float32 that seed the
motion model). These functions turn
the JAX FastVO's arrays, fetched as numpy, into the port's tensors and
back, so both sides can start from the same canvas and carry.

A Map2D engine's state is its kind (`map2d_type`, the Map2D.Type 1-4 of
its class; `bands`, 0 for the single-band Types 1 and 2; `weight_type`),
its canvas (`canvas_lap`/`canvas_w` for Types 3 and 4, `acc`/`wsum` for
Types 1 and 2, all float32) and its host geometry (`min_xy`, `w_tiles`,
`h_tiles`, `length_pixel`, `patch_tiles`, `plane`, the camera, the frame
counters and a RenderMap2D's pending frames). The kind travels with the
canvas because the same arrays mean different things: Type 1's `acc`
holds the sum of weight times colour, Type 2's the blended colour.
`map2d_state_to_numpy` reads it from an engine of either package,
`map2d_state_from_numpy` puts it on a device and `load_map2d_state` makes
a port engine of the same kind continue the same survey from it.

A bundle problem crosses as its arrays in the reference `BAProblem`'s
field order (`ba_problem_from_numpy`), and a camera as the reference's
`Camera.parameters()` vector (`camera_to_parameters`,
`camera_from_parameters`), so both packages can be fed the same problem.

A SLAM's state is its world map: the frames (ids, poses, keyframe flags,
connections, keypoint -> point bindings, GPS and the padded features) and
the points (positions, descriptors, observations), and, for the next
frame, the tracker's motion model, status and last frame and the mapper's
keyframe count, point buffers and plane. `worldmap_to_numpy` reads it
from either package's `WorldMap` or `SLAM`, `worldmap_from_numpy` makes a
port `WorldMap` of it, and `load_worldmap_state` puts it into a port
`SLAM` (or map) so that its next `track` continues the run.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.camera import Camera
from .core.device import resolve_device
from .ops.mosaic import ELE_PIXELS

# the dtypes of a carry (desc, valid, p3d, pose_prev2, pose_est) by detector
CARRY_DTYPES = {
    detector: (desc, torch.bool, torch.float32, torch.float32, torch.float32)
    for detector, desc in (("orb", torch.uint8), ("sift", torch.float32))}


def fastvo_state_from_numpy(canvas_lap, canvas_w, carry=None, device=None):
    """numpy canvas bands (+ optional 5-tuple carry) -> dict of tensors on
    `device` (None means `cuda`, see `resolve_device`): {"canvas_lap":
    [...], "canvas_w": [...], "carry": tuple or None}. The canvas is
    float32; each carry array keeps its own dtype."""
    device = resolve_device(device)

    def t(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype)).to(device)
    return {
        "canvas_lap": [t(a, np.float32) for a in canvas_lap],
        "canvas_w": [t(a, np.float32) for a in canvas_w],
        "carry": None if carry is None else tuple(t(a) for a in carry),
    }


def fastvo_state_to_numpy(state):
    """The inverse of fastvo_state_from_numpy."""
    def n(x):
        return x.detach().cpu().numpy()
    carry = state.get("carry")
    return {
        "canvas_lap": [n(a) for a in state["canvas_lap"]],
        "canvas_w": [n(a) for a in state["canvas_w"]],
        "carry": None if carry is None else tuple(n(a) for a in carry),
    }


def load_fastvo_state(vo, state):
    """Copy a state dict's canvas into a port FastVO's canvas buffers (in
    place; shapes must match). Returns the state's carry on vo.device, to
    be passed as `vo.process(..., carry=...)`, or None."""
    with torch.no_grad():
        for dst, src in zip(vo.canvas_lap + vo.canvas_w,
                            state["canvas_lap"] + state["canvas_w"]):
            if dst.shape != src.shape:
                raise ValueError(f"canvas band {tuple(src.shape)} does not "
                                 f"fit {tuple(dst.shape)}")
            dst.copy_(src)
    carry = state.get("carry")
    if carry is None:
        return None
    want = CARRY_DTYPES[vo.detector]
    got = tuple(a.dtype for a in carry)
    if got != want:
        raise ValueError(f"a {vo.detector} FastVO's carry holds {want}, "
                         f"not {got}")
    return tuple(a.to(vo.device) for a in carry)


# the canvas arrays of a Map2D state, by engine kind, and their dtype
MAP2D_CANVAS = {"multiband": ("canvas_lap", "canvas_w"),
                "weighted": ("acc", "wsum")}
MAP2D_DTYPE = torch.float32
# the Map2D.Type of each engine class (the class names of both packages)
MAP2D_TYPES = {"WeightedMap2D": 1, "WeightedGPUMap2D": 2,
               "MultiBandMap2D": 3, "RenderMap2D": 4}
_GEOMETRY = ("min_xy", "w_tiles", "h_tiles", "length_pixel", "patch_tiles",
             "plane", "frames_rendered", "frames_skipped")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _map2d_kind(engine) -> tuple:
    """(Map2D.Type, bands, weight_type) of an engine of either package."""
    name = type(engine).__name__
    if name not in MAP2D_TYPES:
        raise ValueError(f"{name} is not a Map2D engine of Type 1-4")
    return (MAP2D_TYPES[name], int(getattr(engine, "bands", 0)),
            int(engine.weight_type))


def map2d_state_to_numpy(engine) -> dict:
    """The state of a prepared Map2D engine of either package (the
    reference's arrays or the port's tensors) as numpy and Python
    scalars."""
    st = {k: _host(getattr(engine, k)) for k in _GEOMETRY}
    st["map2d_type"], st["bands"], st["weight_type"] = _map2d_kind(engine)
    for k in ("w_tiles", "h_tiles", "patch_tiles", "frames_rendered",
              "frames_skipped"):
        st[k] = int(st[k])
    st["length_pixel"] = float(st["length_pixel"])
    c = engine.camera
    st["camera"] = (int(c.width), int(c.height), float(c.fx), float(c.fy),
                    float(c.cx), float(c.cy))
    kind = "multiband" if hasattr(engine, "canvas_lap") else "weighted"
    a, b = MAP2D_CANVAS[kind]
    if kind == "multiband":
        st[a] = [_host(x) for x in getattr(engine, a)]
        st[b] = [_host(x) for x in getattr(engine, b)]
    else:
        st[a], st[b] = _host(getattr(engine, a)), _host(getattr(engine, b))
    st["pending"] = [(_host(img), np.asarray(pp, np.float64))
                     for img, pp in getattr(engine, "_pending", [])]
    return st


def map2d_state_from_numpy(state: dict, device=None) -> dict:
    """A numpy Map2D state (`map2d_state_to_numpy`) with its canvas and
    pending frames as tensors on `device` (None means `cuda`). The canvas
    must be float32."""
    device = resolve_device(device)
    out = dict(state)
    for kind, names in MAP2D_CANVAS.items():
        for k in names:
            if k not in state:
                continue
            arrs = state[k] if kind == "multiband" else [state[k]]
            bad = [a.dtype for a in arrs if a.dtype != np.float32]
            if bad:
                raise ValueError(f"a Map2D {k} holds float32, not {bad[0]}")
            ts = [torch.from_numpy(np.array(a)).to(device) for a in arrs]
            out[k] = ts if kind == "multiband" else ts[0]
    out["pending"] = [(torch.from_numpy(np.array(img)).to(device), pp)
                      for img, pp in state.get("pending", [])]
    return out


def _canvas_shapes(state: dict, bands: int):
    """The (colour, weight) shapes of each canvas band of a state's
    geometry: one band for Types 1 and 2, bands + 1 for Types 3 and 4."""
    h = int(state["h_tiles"]) * ELE_PIXELS
    w = int(state["w_tiles"]) * ELE_PIXELS
    return [((h >> i, w >> i, 3), (h >> i, w >> i, 1))
            for i in range(bands + 1)]


def load_map2d_state(engine, state: dict):
    """Make a port Map2D engine (from `create_map2d`, prepared or not)
    continue the survey of `state` (`map2d_state_from_numpy`): its
    geometry, camera, counters, canvas and pending frames are replaced.
    The engine must be of the state's kind (Map2D.Type, bands,
    weight_type) and the canvas must fit the state's tiles. Returns the
    engine."""
    kind = "multiband" if hasattr(engine, "canvas_lap") else "weighted"
    a, b = MAP2D_CANVAS[kind]
    want = _map2d_kind(engine)
    got = tuple(state.get(k) for k in ("map2d_type", "bands",
                                       "weight_type"))
    if got != want:
        raise ValueError(
            f"a {type(engine).__name__} ({a}/{b}; Map2D.Type, bands, "
            f"weight_type {want}) does not take the state of an engine "
            f"with {got}")
    canvas = (list(zip(state[a], state[b])) if kind == "multiband"
              else [(state[a], state[b])])
    shapes = _canvas_shapes(state, want[1])
    if [tuple(t.shape) for pair in canvas for t in pair] != [
            s for pair in shapes for s in pair]:
        raise ValueError(f"the state's {a}/{b} do not fit its "
                         f"{state['h_tiles']}x{state['w_tiles']} tiles")
    for t in (t for pair in canvas for t in pair):
        if t.dtype != MAP2D_DTYPE:
            raise ValueError(f"a Map2D canvas holds {MAP2D_DTYPE}, not "
                             f"{t.dtype}")
    with engine._lock:
        engine.camera = Camera(*state["camera"])
        engine.plane = np.asarray(state["plane"], np.float64)
        engine.min_xy = np.asarray(state["min_xy"], np.float64)
        engine.length_pixel = float(state["length_pixel"])
        for k in ("w_tiles", "h_tiles", "patch_tiles", "frames_rendered",
                  "frames_skipped"):
            setattr(engine, k, int(state[k]))
        if kind == "multiband":
            setattr(engine, a, [t.to(engine.device) for t in state[a]])
            setattr(engine, b, [t.to(engine.device) for t in state[b]])
        else:
            setattr(engine, a, state[a].to(engine.device))
            setattr(engine, b, state[b].to(engine.device))
        if hasattr(engine, "_pending"):
            engine._pending = [(img.to(engine.device),
                                np.asarray(pp, np.float64))
                               for img, pp in state.get("pending", [])]
        elif state.get("pending"):
            raise ValueError("only a RenderMap2D takes pending frames")
    return engine


def ba_problem_from_numpy(arrays, device=None):
    """A port `ops.ba.BAProblem` on `device` (None means `cuda`) from the
    reference BAProblem's arrays as numpy: a dict keyed by its field names,
    or a sequence in its field order (poses, pose_fixed, points,
    point_fixed, obs_frame, obs_point, obs_uv, obs_weight, rel_i, rel_j,
    rel_meas, rel_weight, prior_frame, prior_pose, prior_info). Indices
    become int64, masks bool, the rest float32."""
    from .ops.ba import BAProblem
    device = resolve_device(device)
    fields = BAProblem._fields
    if not isinstance(arrays, dict):
        arrays = dict(zip(fields, arrays))
    if set(arrays) != set(fields):
        raise ValueError(f"a BAProblem has the arrays {fields}, not "
                         f"{tuple(arrays)}")

    def dtype(name):
        if name.endswith("_fixed"):
            return torch.bool
        if name in ("obs_frame", "obs_point", "rel_i", "rel_j",
                    "prior_frame"):
            return torch.int64
        return torch.float32
    return BAProblem(**{k: torch.as_tensor(np.asarray(arrays[k])).to(
        device=device, dtype=dtype(k)) for k in fields})


def camera_to_parameters(camera):
    """The camera's parameter vector (`Camera.parameters()`, either
    package's) as a list of floats."""
    return [float(v) for v in camera.parameters()]


def camera_from_parameters(params):
    """The port's camera model of a parameter vector (PinHole, ATAN,
    OpenCV or OCAM by its length, `Camera.from_parameters`)."""
    return Camera.from_parameters(params)


# ---------------------------------------------------------------------------
# SLAM: the world map (and, from a SLAM, the tracker's and the mapper's
# state that the next frame reads)
# ---------------------------------------------------------------------------

_FRAME_FEATS = ("xy", "desc", "angle", "octave", "response", "valid")
_TRACKER_FIELDS = ("ref_kf_id", "motion", "lost_count")
_MAPPER_FIELDS = ("_kf_count", "_recent_points", "_plane_buffer",
                  "_plane_sent", "plane_se3", "gps_fitted")


def _copy(v):
    return None if v is None else np.array(v)


def _plain(v):
    """A copy of a list, an array or a scalar field."""
    if isinstance(v, list):
        return list(v)
    if isinstance(v, np.ndarray):
        return v.copy()
    return v


def _frame_to_numpy(f) -> dict:
    """One frame of either package as plain values (features through its
    host views, so a frame whose features are on a device is copied)."""
    d = {"id": int(f.id), "timestamp": float(f.timestamp),
         "camera": camera_to_parameters(f.camera),
         "pose_c2w": np.array(f.pose_c2w, np.float32),
         "is_keyframe": bool(f.is_keyframe), "desc_kind": f.desc_kind,
         "kp2mp": _copy(f.kp2mp), "connections": dict(f.connections),
         "gps_lla": _copy(f.gps_lla), "gps_enu": _copy(f.gps_enu),
         "gps_acc": float(f.gps_acc), "pyr": _copy(f.pyr),
         "height_ground": f.height_ground, "image": _copy(f.image),
         "color": _copy(f.color)}
    has = f.n_kp > 0
    for k in _FRAME_FEATS:
        d[k] = _copy(getattr(f, k)) if has else None
    return d


def worldmap_to_numpy(slam_or_map) -> dict:
    """A WorldMap of either package (or a SLAM, whose map it reads) as
    numpy: {"frames": [frame dicts: id, timestamp, camera parameters,
    pose_c2w, is_keyframe, desc_kind, kp2mp, connections, GPS, image and
    the padded features xy/desc/angle/octave/response/valid], "points":
    [point dicts: id, position, descriptor, normal, color, ref_frame,
    observations, bad, created_at_kf], "keyframe_ids", "next_fid",
    "next_pid"}. From a SLAM it also holds "tracker" (status, ref_kf_id,
    motion, lost_count and the last frame) and "mapper" (its keyframe
    count, recent and plane-buffer point ids, plane and GPS state)."""
    wmap = getattr(slam_or_map, "map", None) or slam_or_map
    with wmap._lock:
        state = {
            "frames": [_frame_to_numpy(f) for f in wmap._frames.values()],
            "points": [{
                "id": int(p.id),
                "position": np.array(p.position, np.float32),
                "descriptor": np.array(p.descriptor),
                "normal": np.array(p.normal, np.float32),
                "color": np.array(p.color, np.uint8),
                "ref_frame": int(p.ref_frame),
                "observations": dict(p.observations), "bad": bool(p.bad),
                "created_at_kf": int(p.created_at_kf)}
                for p in wmap._points.values()],
            "keyframe_ids": list(wmap._keyframe_ids),
            "next_fid": int(wmap._next_fid),
            "next_pid": int(wmap._next_pid)}
    tracker = getattr(slam_or_map, "tracker", None)
    if tracker is not None:
        st = {k: _plain(getattr(tracker, k)) for k in _TRACKER_FIELDS}
        st["status"] = tracker.status.name
        last = tracker.last_frame
        st["last_frame"] = None if last is None else _frame_to_numpy(last)
        state["tracker"] = st
        mapper = slam_or_map.mapper
        state["mapper"] = {k: _plain(getattr(mapper, k))
                           for k in _MAPPER_FIELDS}
    return state


def _frame_from_numpy(d, device):
    from .models.frame import Frame
    f = Frame(id=d["id"], timestamp=d["timestamp"],
              camera=camera_from_parameters(d["camera"]),
              image=_copy(d.get("image")), color=_copy(d.get("color")))
    f.pose_c2w = np.array(d["pose_c2w"], np.float32)
    f.is_keyframe = d["is_keyframe"]
    f.desc_kind = d["desc_kind"]
    f.connections = dict(d["connections"])
    for k in ("gps_lla", "gps_enu", "pyr"):
        setattr(f, k, _copy(d[k]))
    f.gps_acc = d["gps_acc"]
    f.height_ground = d["height_ground"]
    if d["xy"] is not None:
        feats = {k: d[k] for k in _FRAME_FEATS}
        f.set_features(feats, d["desc_kind"])
        if device is not None:
            f.feats_dev = {k: torch.from_numpy(np.array(f._feats[k])).to(
                device) for k in _FRAME_FEATS}
    f.kp2mp = _copy(d["kp2mp"])
    return f


def worldmap_from_numpy(state: dict, device=None):
    """A port WorldMap from `worldmap_to_numpy`'s state. Each frame gets
    host features and, on `device` (None means `cuda`, see
    `resolve_device`), device copies of them, as the port's tracker leaves
    them."""
    from .models.worldmap import WorldMap
    wmap = WorldMap()
    _fill_worldmap(wmap, state, resolve_device(device))
    return wmap


def _fill_worldmap(wmap, state, device):
    from .models.frame import MapPoint
    with wmap.update_lock, wmap._lock:
        wmap._frames.clear()
        wmap._points.clear()
        wmap._keyframe_ids.clear()
        wmap._kf_center_cache = None
        wmap.version += 1
        for d in state["frames"]:
            f = _frame_from_numpy(d, device)
            wmap._frames[f.id] = f
        wmap._keyframe_ids.extend(state["keyframe_ids"])
        for d in state["points"]:
            mp = MapPoint(id=d["id"], position=_copy(d["position"]),
                          descriptor=_copy(d["descriptor"]),
                          normal=_copy(d["normal"]), color=_copy(d["color"]),
                          ref_frame=d["ref_frame"],
                          observations=dict(d["observations"]),
                          bad=d["bad"], created_at_kf=d["created_at_kf"])
            wmap._points[mp.id] = mp
        wmap._next_fid = state["next_fid"]
        wmap._next_pid = state["next_pid"]


def load_worldmap_state(slam_or_map, state: dict):
    """Replace the contents of a port WorldMap (in place, so modules that
    hold it keep it) with `worldmap_to_numpy`'s state. For a port SLAM,
    its modules are made first (on its device), and the state's tracker
    and mapper entries, when present, are copied into them, so its next
    `track` continues the captured run. Returns slam_or_map."""
    slam = slam_or_map if hasattr(slam_or_map, "tracker") else None
    if slam is not None:
        slam._ensure_modules()
        wmap, device = slam.map, slam.device
    else:
        wmap, device = slam_or_map, None
    _fill_worldmap(wmap, state, device)
    if slam is not None and "tracker" in state:
        from .models.tracker import Status
        tr, st = slam.tracker, state["tracker"]
        for k in _TRACKER_FIELDS:
            setattr(tr, k, _plain(st[k]))
        tr.status = Status[st["status"]]
        last = st["last_frame"]
        tr.last_frame = None if last is None else (
            wmap.frame(last["id"]) or _frame_from_numpy(last, device))
        tr.last_prev = None
        tr.invalidate_local_stage()
        for k, v in state["mapper"].items():
            setattr(slam.mapper, k, _plain(v))
    return slam_or_map
