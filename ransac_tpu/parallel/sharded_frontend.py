"""Keyframe-axis sharded feature front end (SURVEY.md §2.5 row 4).

The reference processes one image at a time (a single historical photo per
run, ``/root/reference/main_v1.py:846``); the framework's multi-frame
generalization batches detect → describe → match over a keyframe axis and
shards that axis over the mesh ``data`` dimension with ``shard_map``:

- every device runs Harris detection + patch description on its local
  contiguous block of frames (pure vmap — no communication);
- consecutive-pair matching needs each block's RIGHT neighbor's first
  frame, exchanged with one ``lax.ppermute`` hop over the ``data`` axis
  (descriptors + validity move once per step, ~K*D floats);
- outputs keep global frame order, so the host-side track chaining and
  the SfM pipeline (``pipelines.sfm.incremental_sfm``) consume the
  distributed and single-device results identically.

This is the substrate for the BASELINE.md "frames/s at N hosts" metric —
``utils.scaling.measure_frontend_scaling`` times it across mesh sizes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ransac_tpu.features.detect import detect_harris
from ransac_tpu.features.match import mutual_nn_match, patch_descriptors
from ransac_tpu.utils.config import TwoViewConfig


@functools.partial(jax.jit, static_argnames=("max_kp", "nms_radius",
                                             "patch"))
def frontend_frames(images: jnp.ndarray, max_kp: int = 512,
                    nms_radius: int = 4, harris_k: float = 0.04,
                    patch: int = 8):
    """Batched detect + describe over a [F, H, W] frame stack.

    Returns ``(xy [F, K, 2], valid [F, K], desc [F, K, patch^2])`` with
    fixed shapes (slots masked by ``valid``)."""

    def per_frame(img):
        kp = detect_harris(img, max_kp, nms_radius, harris_k)
        d = patch_descriptors(img, kp.xy, kp.valid, patch)
        return kp.xy, kp.valid, d

    return jax.vmap(per_frame)(images.astype(jnp.float32))


@functools.partial(jax.jit, static_argnames=("ratio",))
def match_consecutive(xy, valid, desc, ratio: float = 0.9):
    """Mutual-NN match frame f against f+1 for all consecutive pairs.

    Returns ``(idx2 [F-1, K], mvalid [F-1, K])``: match slot k of pair f
    maps keypoint k of frame f to keypoint ``idx2[f, k]`` of frame f+1.
    """

    def pair(d1, d2, v1, v2):
        m = mutual_nn_match(d1, d2, v1, v2, ratio)
        return m.idx2, m.valid

    return jax.vmap(pair)(desc[:-1], desc[1:], valid[:-1], valid[1:])


def distributed_frontend(images, mesh: Mesh,
                         cfg: TwoViewConfig = TwoViewConfig()):
    """Sharded multi-frame front end over the mesh ``data`` axis.

    ``images``: [F, H, W] with F divisible by the data-axis size.  Returns
    ``(xy [F, K, 2], valid [F, K], desc [F, K, D], idx2 [F, K],
    mvalid [F, K])`` — rows ``0..F-2`` of the match arrays are the
    consecutive pairs (row f matches frame f to f+1); row F-1 is the
    wrapped boundary of the last device and is always all-invalid.

    Bit-identical to the single-device ``frontend_frames`` +
    ``match_consecutive`` path (asserted in tests/test_parallel.py): the
    per-frame work is local, and the one cross-device dependency (each
    block's last frame matching the next block's first) arrives by a
    single ``ppermute`` hop.
    """
    n_data = mesh.shape["data"]
    F = images.shape[0]
    assert F % n_data == 0, (F, n_data)
    images = jnp.asarray(images, jnp.float32)

    def local_block(imgs):
        xy, valid, desc = frontend_frames(
            imgs, cfg.max_keypoints, cfg.nms_radius, cfg.harris_k,
            cfg.patch_size)
        # Right-neighbor's first frame -> this device (left shift).
        perm = [(i + 1, i) for i in range(n_data - 1)]
        nb_desc = jax.lax.ppermute(desc[:1], "data", perm)
        nb_valid = jax.lax.ppermute(valid[:1], "data", perm)
        is_last = jax.lax.axis_index("data") == n_data - 1
        nb_valid = jnp.where(is_last, jnp.zeros_like(nb_valid), nb_valid)
        d2 = jnp.concatenate([desc[1:], nb_desc], axis=0)
        v2 = jnp.concatenate([valid[1:], nb_valid], axis=0)

        def pair(d1, dd2, v1, vv2):
            m = mutual_nn_match(d1, dd2, v1, vv2, cfg.match_ratio)
            return m.idx2, m.valid

        idx2, mvalid = jax.vmap(pair)(desc, d2, valid, v2)
        return xy, valid, desc, idx2, mvalid

    spec = P("data")
    fn = shard_map(
        local_block, mesh=mesh, in_specs=(spec,),
        out_specs=(spec,) * 5, check_vma=False,
    )
    images = jax.device_put(images, NamedSharding(mesh, spec))
    return fn(images)


def matches_to_tracks(xy, idx2, mvalid, min_len: int = 2) -> dict:
    """Chain consecutive-pair matches into SfM tracks.

    ``xy [F, K, 2]``, ``idx2 [P, K]``, ``mvalid [P, K]`` with P >= F-1
    (extra rows ignored).  Returns ``{(frame, track_id): uv ndarray[2]}``
    — the input format of :func:`ransac_tpu.pipelines.sfm.incremental_sfm`
    — keeping tracks observed in at least ``min_len`` frames.
    """
    xy = np.asarray(xy)
    idx2 = np.asarray(idx2)
    mvalid = np.asarray(mvalid).astype(bool)
    F, K = xy.shape[:2]
    # Vectorized label propagation (VERDICT r2 next-steps #5: the per-match
    # Python dict loop was the scaling bottleneck at hundreds of frames):
    # one numpy step per frame carries track labels from frame f's matched
    # keypoints to their targets in frame f+1; unlabeled matched keypoints
    # open new tracks in ascending-k order.  For duplicate targets the
    # lowest-k chain wins, matching the old first-wins dict order (the
    # dropped duplicate source would only ever form a min_len<2 singleton,
    # which was filtered anyway).
    label = np.full((F, K), -1, np.int64)
    next_tid = 0
    for f in range(min(F - 1, len(mvalid))):
        ks = np.nonzero(mvalid[f])[0]
        if ks.size == 0:
            continue
        tgt = idx2[f, ks]
        _, first = np.unique(tgt, return_index=True)
        ks = ks[np.sort(first)]
        tgt = idx2[f, ks]
        lab = label[f, ks]
        new = lab < 0
        n_new = int(new.sum())
        lab[new] = next_tid + np.arange(n_new)
        next_tid += n_new
        label[f, ks] = lab
        label[f + 1, tgt] = lab
    fs, kk = np.nonzero(label >= 0)
    tids = label[fs, kk]
    counts = np.bincount(tids, minlength=max(next_tid, 1))
    sel = counts[tids] >= min_len
    uvs = xy[fs, kk].astype(np.float64)
    return {(int(f), int(t)): uv
            for f, t, uv in zip(fs[sel], tids[sel], uvs[sel])}
