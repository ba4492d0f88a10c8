"""The point-, cluster- and object-adding attacks (CVPR'19 CW-Add family;
port of `hitadv_tpu/attacks/add.py`):
  * CW-Add (`CW/Add.py:14-220`): ``num_add`` = 512 free points seeded at
    the "critical points" (the top points by CE-gradient magnitude), the
    added-to-original Chamfer distance, a binary search over its weight;
  * CW-Add-Cluster (`CW/Add_Cluster.py:48-278`): 3 clusters of 32 points
    seeded by DBSCAN (eps 0.2, 3 points) over 128 critical points, the
    compactness + proximity distance `far_chamfer_dist`;
  * CW-Add-Object (`CW/Add_Objects.py:50-367`): 3 rigid objects of 64
    points (a normalised, scaled object cloud), their shape, shift and
    y-axis rotation optimised, the angles wrapped into [0, 2 pi), the
    distance `l2_chamfer_dist`.

All three are targeted: an iterate succeeds when the victim gives the
label it was handed. The victim sees the original points with the added
ones behind them, and the attack returns that concatenation. The DBSCAN
seeding runs on the host in numpy, once a batch, as in the reference;
everything else stays on the device, and the loops wait for nothing
there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from hitadv_torch import resolve_device
from hitadv_torch.attacks.base import (
    AttackResult,
    BestState,
    Draws,
    adam_init,
    adam_update,
    binary_search_update,
    update_best,
)
from hitadv_torch.losses import (
    chamfer_dist,
    cross_entropy_loss,
    far_chamfer_dist,
    l2_chamfer_dist,
)
from hitadv_torch.ops import geometry as G
from hitadv_torch.parallel.shard import (
    batch_draw,
    batch_mean,
    gather_batch,
    own_rows,
)


# ---------------------------------------------------------------------------
# Seeding
# ---------------------------------------------------------------------------

def get_critical_points(logits_fn: Callable, pc: torch.Tensor,
                        labels: torch.Tensor, num: int) -> torch.Tensor:
    """The ``num`` points of largest squared CE-gradient norm, ``[B, N,
    3] -> [B, num, 3]`` (reference `CW/Add.py:14-42`).

    A max-pool victim gives an exact zero gradient to every point that is
    no channel's argmax, so the cut often falls inside a block of equal
    scores. `lax.top_k` takes equal scores in index order, and so does a
    stable descending sort; `torch.topk` leaves their order open."""
    with torch.enable_grad():
        x = pc.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(
            batch_mean(cross_entropy_loss(logits_fn(x), labels)), x)
    score = torch.sum(grad ** 2, dim=-1)                      # [B, N]
    idx = torch.sort(score, dim=1, descending=True, stable=True).indices
    return G.index_points(pc, idx[:, :num].contiguous())


def dbscan_np(points: np.ndarray, eps: float,
              min_samples: int) -> np.ndarray:
    """Minimal DBSCAN, ``[N, 3] -> labels [N]`` (-1 noise), with sklearn's
    semantics: a core point has at least ``min_samples`` points (itself
    included) within ``eps``; clusters grow from the cores breadth-first,
    in index order."""
    n = len(points)
    d2 = np.sum((points[:, None] - points[None]) ** 2, axis=-1)
    neigh = d2 <= eps * eps
    core = neigh.sum(1) >= min_samples
    labels = np.full(n, -1, dtype=np.int64)
    cluster = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        stack = [i]
        labels[i] = cluster
        while stack:
            j = stack.pop()
            if not core[j]:
                continue
            for k in np.where(neigh[j])[0]:
                if labels[k] == -1:
                    labels[k] = cluster
                    stack.append(k)
        cluster += 1
    return labels


def _cluster_seeds(cri_points: np.ndarray, num_add: int, cl_num_p: int,
                   rng: np.random.RandomState,
                   as_centers: bool = False) -> np.ndarray:
    """DBSCAN seeds over each cloud's critical points (reference
    `CW/Add_Cluster.py:83-130`, `CW/Add_Objects.py:100-146`: eps 0.2,
    3 points; the ``num_add`` largest clusters; a random point's nearest
    neighbours where too few clusters form). Returns ``[B, num_add,
    cl_num_p, 3]`` cluster seeds, or ``[B, num_add, 3]`` centres with
    ``as_centers``. ``rng`` is drawn from in the reference's order."""
    out = []
    for points in cri_points:                                 # [num_cri, 3]
        result = dbscan_np(points, eps=0.2, min_samples=3)
        keep = result > -0.5
        res, pts = result[keep], points[keep]
        if len(pts) == 0:
            res, pts = np.zeros(len(points), np.int64), points
        labels, counts = np.unique(res, return_counts=True)
        sel = labels[np.argsort(counts)[-num_add:]]
        items = []
        for lab in sel:
            cp = pts[res == lab]
            if as_centers:
                center = cp.mean(0)
                items.append(cp[np.argmin(np.sum((cp - center) ** 2, 1))])
            else:
                replace = not (len(cp) > cl_num_p)
                items.append(cp[rng.choice(len(cp), cl_num_p,
                                           replace=replace)])
        while len(items) < num_add:                           # fallback
            rand_point = pts[rng.choice(len(pts), 1)[0]]
            if as_centers:
                items.append(rand_point)
            else:
                d = np.sum((pts - rand_point[None]) ** 2, axis=1)
                # repeated when fewer than cl_num_p points survive
                items.append(pts[np.resize(np.argsort(d)[:cl_num_p],
                                           cl_num_p)])
        out.append(np.stack(items))
    return np.stack(out)


def _seed_points(logits_fn, ori, labels, num_cri, seeds_of, dev):
    """The critical points' DBSCAN seeds (``seeds_of(numpy points)``) as
    an f32 tensor on ``dev``: one copy to the host a batch. Under a batch
    sharding every rank seeds the whole batch's critical points, in
    order, and keeps its rows: the host generators draw as in one
    process."""
    cri = gather_batch(get_critical_points(logits_fn, ori, labels, num_cri))
    return own_rows(torch.from_numpy(np.asarray(
        seeds_of(cri.cpu().numpy()), np.float32)).to(dev))


def _inputs(points, labels, dev):
    points = torch.as_tensor(points, dtype=torch.float32).to(dev)
    return (points[..., :3].contiguous(),
            torch.as_tensor(labels).to(dev).long())


def _finish(logits_fn, ori, success, best_added, last_added):
    """Successes take their best added points, failures the last ones;
    the originals go in front (reference `CW/Add.py:200-213`)."""
    added = torch.where(success[:, None, None], best_added, last_added)
    adv = torch.cat([ori, added], dim=1)
    with torch.no_grad():
        pred = torch.argmax(logits_fn(adv), dim=-1)
    return AttackResult(adv_points=adv, success=success, pred=pred)


def _found(best: BestState, o_best: BestState, labels: torch.Tensor):
    """The binary search's success test (reference `CW/Add.py:180-186`):
    this step's best reached the target and is no farther than the best
    of all steps."""
    return ((best.score == labels) & (best.score != -1)
            & (best.dist <= o_best.dist))


def _optimize_added(logits_fn, adv_fn, dist_fn, cfg, ori, labels, start,
                    draws, generator, dev) -> AttackResult:
    """The binary search x Adam over free added points ``[B, A, 3]``
    started at ``start`` plus each step's 1e-7 noise (Add and
    Add-Cluster)."""
    B = ori.shape[0]
    lower = torch.zeros(B, device=dev)
    upper = torch.full((B,), cfg.max_weight, device=dev)
    weight = torch.full((B,), cfg.init_weight, device=dev)
    o_best = BestState.init(start)
    adv = torch.zeros_like(start)
    for step in range(cfg.binary_step):
        adv = start + draws.noise(start.shape, generator, step)
        opt = adam_init(adv)
        best = BestState.init(start)
        for _ in range(cfg.num_iter):
            with torch.enable_grad():
                x = adv.detach().requires_grad_(True)
                logits = logits_fn(torch.cat([ori, x], dim=1))
                dist = dist_fn(x, ori)
                loss = (batch_mean(adv_fn(logits, labels))
                        + batch_mean(dist * weight))
                (grad,) = torch.autograd.grad(loss, x)
            with torch.no_grad():
                # the iterate before its step (`CW/Add.py:140-160`)
                pred = torch.argmax(logits, dim=-1)
                ok = pred == labels
                dist = dist.detach()
                best = update_best(best, ok, dist, pred, adv)
                o_best = update_best(o_best, ok, dist, pred, adv)
                adv, opt = adam_update(grad, opt, adv, cfg.attack_lr)
        lower, upper, weight = binary_search_update(
            _found(best, o_best, labels), lower, upper, weight)
    return _finish(logits_fn, ori, lower > 0.0, o_best.adv, adv)


# ---------------------------------------------------------------------------
# CW-Add
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AddConfig:
    """Defaults of `CW/Add.py:49-51`."""
    attack_lr: float = 1e-2
    init_weight: float = 5e3
    max_weight: float = 4e4
    binary_step: int = 10
    num_iter: int = 500
    num_add: int = 512


def make_cw_add(logits_fn: Callable, adv_fn: Callable,
                cfg: AddConfig = AddConfig(), *,
                init_overrides: Optional[Mapping] = None, device="cuda"):
    """CW-Add: ``num_add`` free points started on the critical points.

    Args:
      logits_fn: victim ``[B, N', 3] -> [B, classes]`` on ``device``.
      adv_fn: targeted per-example loss ``(logits, target) -> [B]``; the
        distance is the added-to-original Chamfer distance.
      init_overrides: optional ``{"noise": [S, B, num_add, 3]}`` pinning
        each binary step's 1e-7 noise (`CW/Add.py:108-109`). The added
        points start on original points, so the noise sets the first
        Chamfer gradient's direction: comparing with the JAX package
        needs the same draws.
      device: where the attack runs; ``"cuda"`` unless the caller asks
        for the CPU.
    Returns:
      ``attack(points [B, N, >=3], labels, generator) -> AttackResult``
      with ``adv_points`` ``[B, N + num_add, 3]``; ``generator`` may be
      None only with ``init_overrides``.
    """
    dev = resolve_device(device)
    draws = Draws(init_overrides, ("noise",), dev)

    def attack(points, labels, generator: Optional[torch.Generator] = None
               ) -> AttackResult:
        draws.check(generator)
        ori, labels = _inputs(points, labels, dev)
        cri = get_critical_points(logits_fn, ori, labels, cfg.num_add)
        return _optimize_added(logits_fn, adv_fn, chamfer_dist, cfg, ori,
                               labels, cri, draws, generator, dev)

    return attack


# ---------------------------------------------------------------------------
# CW-Add-Cluster
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AddClusterConfig:
    """Defaults of `CW/Add_Cluster.py:52-54`."""
    attack_lr: float = 1e-2
    init_weight: float = 5.0
    max_weight: float = 30.0
    binary_step: int = 5
    num_iter: int = 500
    num_add: int = 3
    cl_num_p: int = 32
    num_cri: int = 128


def make_cw_add_clusters(logits_fn: Callable, adv_fn: Callable,
                         cfg: AddClusterConfig = AddClusterConfig(),
                         seed: int = 0, *,
                         init_overrides: Optional[Mapping] = None,
                         device="cuda"):
    """CW-Add-Cluster: compact clusters seeded by DBSCAN.

    Each call seeds from a fresh ``np.random.RandomState(seed)``, as the
    JAX package does. ``init_overrides``: ``{"noise": [S, B, A, 3]}`` (A
    = num_add * cl_num_p), each binary step's 1e-7 noise
    (`CW/Add_Cluster.py:167-169`), and optionally ``"clusters"`` ``[B, A,
    3]``, the seeds in place of the DBSCAN ones. Arguments and result
    otherwise as `make_cw_add`'s, with A added points.

    The binary search's bookkeeping is the reference's inline one, which
    is `update_best`'s rule: a success that is strictly closer."""
    dev = resolve_device(device)
    A = cfg.num_add * cfg.cl_num_p
    draws = Draws(init_overrides, ("noise",), dev)
    clusters = None
    if init_overrides is not None and "clusters" in init_overrides:
        clusters = torch.as_tensor(init_overrides["clusters"],
                                   dtype=torch.float32).to(dev)

    def dist_fn(added, ori):
        return far_chamfer_dist(added, ori, cfg.num_add)

    def attack(points, labels, generator: Optional[torch.Generator] = None
               ) -> AttackResult:
        draws.check(generator)
        ori, labels = _inputs(points, labels, dev)
        start = clusters
        if start is None:
            start = _seed_points(
                logits_fn, ori, labels, cfg.num_cri,
                lambda cri: _cluster_seeds(cri, cfg.num_add, cfg.cl_num_p,
                                           np.random.RandomState(seed)),
                dev).reshape(ori.shape[0], A, 3)
        return _optimize_added(logits_fn, adv_fn, dist_fn, cfg, ori, labels,
                               start, draws, generator, dev)

    return attack


# ---------------------------------------------------------------------------
# CW-Add-Object
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AddObjectConfig:
    """Defaults of `CW/Add_Objects.py:54-56`."""
    attack_lr: float = 1e-2
    init_weight: float = 5.0
    max_weight: float = 40.0
    binary_step: int = 5
    num_iter: int = 500
    num_add: int = 3
    obj_num_p: int = 64
    scaling: float = 0.3
    num_cri: int = 128


def default_object_pc(num_points: int = 256, seed: int = 0) -> np.ndarray:
    """Points on the unit sphere, the object when none is given (the
    reference loads an object cloud from a file)."""
    rng = np.random.RandomState(seed)
    v = rng.randn(num_points, 3)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def rotate_shift(objs: torch.Tensor, angles: torch.Tensor,
                 shifts: torch.Tensor) -> torch.Tensor:
    """Each object ``[B, na, P, 3]`` rotated about the y axis by its
    ``angles[..., 0]`` and moved by its ``shifts`` ``[B, na, 3]``
    (reference `CW/Add_Objects.py:148-185`)."""
    ang = angles[..., 0]                                      # [B, na]
    c, s = torch.cos(ang), torch.sin(ang)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([c, z, s, z, o, z, -s, z, c],
                      dim=-1).reshape(*ang.shape, 3, 3)
    return torch.matmul(objs, rot) + shifts[:, :, None, :]


def object_subsets(cfg: AddObjectConfig, seed: int = 0):
    """The objects of `make_cw_add_objects`, ``[num_add, obj_num_p, 3]``
    f32: `default_object_pc(seed=seed)` normalised and scaled
    (`CW/Add_Objects.py:94-98`), then ``num_add`` shuffled subsets of
    ``obj_num_p`` points drawn from a fresh ``RandomState(seed)``, which
    is returned with them."""
    rng = np.random.RandomState(seed)
    object_pc = default_object_pc(seed=seed)
    pc = object_pc - object_pc.mean(0, keepdims=True)
    pc = pc / (np.linalg.norm(pc, axis=1).max() + 1e-9) * cfg.scaling
    objects = np.zeros((cfg.num_add, cfg.obj_num_p, 3), np.float32)
    for i in range(cfg.num_add):
        objects[i] = pc[rng.permutation(len(pc))[:cfg.obj_num_p]]
    return objects, rng


def make_cw_add_objects(logits_fn: Callable, adv_fn: Callable,
                        cfg: AddObjectConfig = AddObjectConfig(),
                        seed: int = 0, *,
                        init_overrides: Optional[Mapping] = None,
                        device="cuda"):
    """CW-Add-Object: rigid objects whose shape, shift and rotation are
    learned.

    One ``np.random.RandomState(seed)`` is made here: it draws the
    objects' point subsets now (`object_subsets`) and the DBSCAN
    fallback of every batch after, as in the JAX package.

    init_overrides: optional, pinning every draw (`CW/Add_Objects.py:
    227-241`): ``"noise_obj"`` ``[S, B, num_add, obj_num_p, 3]`` and
    ``"noise_shift"`` ``[S, B, num_add, 3]``, each binary step's 1e-7
    noise; ``"angles"`` ``[S, B, num_add, 3]``, each step's start angles;
    and, each optional, ``"objects"`` ``[num_add, obj_num_p, 3]`` and
    ``"centers"`` ``[B, num_add, 3]`` in place of the subsets and the
    DBSCAN centres. Arguments and result otherwise as `make_cw_add`'s,
    with num_add * obj_num_p added points.
    """
    dev = resolve_device(device)
    objects, rng = object_subsets(cfg, seed)
    draws = Draws(init_overrides, ("noise_obj", "noise_shift", "angles"),
                  dev)
    overrides = dict(init_overrides or {})
    if "objects" in overrides:
        objects = np.asarray(overrides["objects"], np.float32)
    objects = torch.from_numpy(objects).to(dev)
    centers = None
    if "centers" in overrides:
        centers = torch.as_tensor(overrides["centers"],
                                  dtype=torch.float32).to(dev)
    A = cfg.num_add * cfg.obj_num_p

    def attack(points, labels, generator: Optional[torch.Generator] = None
               ) -> AttackResult:
        draws.check(generator)
        ori, labels = _inputs(points, labels, dev)
        B = ori.shape[0]
        centers0 = centers
        if centers0 is None:
            centers0 = _seed_points(
                logits_fn, ori, labels, cfg.num_cri,
                lambda cri: _cluster_seeds(cri, cfg.num_add, 1, rng,
                                           as_centers=True),
                dev).reshape(B, cfg.num_add, 3)
        clean_objs = objects[None].expand(B, -1, -1, -1)

        def dist(added, objs):
            return l2_chamfer_dist(added, ori, objs, clean_objs)

        lower = torch.zeros(B, device=dev)
        upper = torch.full((B,), cfg.max_weight, device=dev)
        weight = torch.full((B,), cfg.init_weight, device=dev)
        zeros_add = torch.zeros((B, A, 3), device=dev)
        o_best = BestState.init(zeros_add)
        last = zeros_add
        for step in range(cfg.binary_step):
            if draws.pinned:
                noise_obj = draws.pinned["noise_obj"][step]
                noise_shift = draws.pinned["noise_shift"][step]
                angles = draws.pinned["angles"][step]
            else:
                def normal(shape):
                    return torch.randn(shape, generator=generator,
                                       device=dev)
                noise_obj = batch_draw(normal, clean_objs.shape) * 1e-7
                noise_shift = batch_draw(normal, centers0.shape) * 1e-7
                angles = batch_draw(lambda s: torch.rand(
                    s, generator=generator, device=dev),
                    (B, cfg.num_add, 3)) * math.pi
            objs, shifts = clean_objs + noise_obj, centers0 + noise_shift
            opts = [adam_init(t) for t in (objs, shifts, angles)]
            best = BestState.init(zeros_add)
            for _ in range(cfg.num_iter):
                with torch.enable_grad():
                    xs = [t.detach().requires_grad_(True)
                          for t in (objs, shifts, angles)]
                    added = rotate_shift(xs[0], xs[2], xs[1]).reshape(
                        B, A, 3).contiguous()
                    logits = logits_fn(torch.cat([ori, added], dim=1))
                    d = dist(added, xs[0])
                    loss = (batch_mean(adv_fn(logits, labels))
                            + batch_mean(d * weight))
                    grads = torch.autograd.grad(loss, xs)
                with torch.no_grad():
                    added = added.detach()
                    pred = torch.argmax(logits, dim=-1)
                    ok = pred == labels
                    d = d.detach()
                    best = update_best(best, ok, d, pred, added)
                    o_best = update_best(o_best, ok, d, pred, added)
                    objs, opts[0] = adam_update(grads[0], opts[0], objs,
                                                cfg.attack_lr)
                    shifts, opts[1] = adam_update(grads[1], opts[1], shifts,
                                                  cfg.attack_lr)
                    angles, opts[2] = adam_update(grads[2], opts[2], angles,
                                                  cfg.attack_lr)
                    # jnp.mod's floor mod (`:337`); fmod would keep the
                    # sign of a negative angle
                    angles = torch.remainder(angles, 2.0 * math.pi)
                    # the fallback is the placement before this step: the
                    # reference's `input_val` is a fresh copy there
                    # (`CW/Add_Objects.py:294`), no alias of the tensor
                    # being optimised
                    last = added
            lower, upper, weight = binary_search_update(
                _found(best, o_best, labels), lower, upper, weight)
        return _finish(logits_fn, ori, lower > 0.0, o_best.adv, last)

    return attack
