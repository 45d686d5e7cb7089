"""Checkpoint / resume: per-shard .npy files + a JSON manifest.

Port of ``heat3d_tpu.utils.checkpoint`` in the same on-disk format, so a
checkpoint moves between the two packages byte for byte:

- ``shard_<start>.npy`` per shard, ``<start>`` the shard's origin in the
  padded storage shape (``SolverConfig.padded_shape``), bc padding
  included;
- a ``<shard>.crc32`` sidecar per shard (crc32 of the saved array bytes,
  eight lower-case hex digits);
- ``manifest.json`` format 1: ``step``, ``global_shape`` (the padded
  shape), ``dtype`` (the NumPy/JAX name: ``float32``, ``bfloat16``),
  ``checksums``, ``shards`` (every shard start of the save) and ``extra``.

bf16 is saved as its ``uint16`` bit pattern, as the JAX package saves
``ml_dtypes.bfloat16``, and loaded back through an ``int16`` view into
``torch.bfloat16``: no ``ml_dtypes`` needed. The field is the port's: a
``ShardedField`` or, on a (1,1,1) mesh, one tensor. A save waits for every
stream of every CUDA device the shards are on before it copies them to the
host; a load copies each shard onto its own device on the device's current
stream, which the solver's shard streams wait for before their first step.
A load onto another mesh than the save's stitches each shard from the
saved blocks that overlap it (``_resolve_shard``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.decomposition import coords_of_rank

MANIFEST = "manifest.json"
CRC_SUFFIX = ".crc32"


class ShardCorruptError(Exception):
    """A shard file's bytes disagree with its checksum sidecar.

    Raised on load/stitch/consolidate reads (never silently repaired):
    the caller decides whether to quarantine and fall back a generation
    (the supervisor's policy) or abort."""

    def __init__(self, path: str, filename: str, want: str, got: str):
        self.path = path
        self.filename = filename
        super().__init__(
            f"checkpoint {path}: shard {filename} fails its checksum "
            f"(sidecar {want}, data {got}) — the file is corrupt; "
            "quarantine it and fall back to the previous generation"
        )


@contextlib.contextmanager
def _timed(stats: Optional[dict], key: str):
    """Add the block's seconds to ``stats[key]`` (no-op without stats)."""
    if stats is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats[key] = stats.get(key, 0.0) + time.perf_counter() - t0


def _crc32_hex(arr: np.ndarray) -> str:
    return format(zlib.crc32(np.ascontiguousarray(arr).data), "08x")


def _verify_enabled() -> bool:
    return os.environ.get("HEAT3D_CKPT_VERIFY", "1").lower() not in (
        "0",
        "false",
    )


def _maybe_verify(path: str, fn: str, arr: np.ndarray, stats=None) -> None:
    """Check ``arr`` (the loaded shard ``fn``) against its CRC sidecar.

    Sidecar-less shards pass (pre-checksum checkpoints stay loadable).
    Works on memmaps too — crc32 streams the pages in without a second
    full materialization."""
    if not _verify_enabled():
        return
    try:
        with open(os.path.join(path, fn + CRC_SUFFIX)) as f:
            want = f.read().strip()
    except OSError:
        return
    with _timed(stats, "crc_s"):
        got = _crc32_hex(arr)
    if got != want:
        obs.REGISTRY.counter(
            "ckpt_verify_total", "shard checksum verifications"
        ).inc(result="corrupt")
        obs.get().event(
            "ckpt_corrupt", path=path, shard=fn, want=want, got=got
        )
        raise ShardCorruptError(path, fn, want, got)
    obs.REGISTRY.counter(
        "ckpt_verify_total", "shard checksum verifications"
    ).inc(result="ok")


def quarantine(path: str, reason: str = "") -> str:
    """Move a corrupt checkpoint directory (or single shard file) out of
    the load path as ``<path>.quarantined[.N]`` — preserved for
    post-mortem, invisible to generation scans. Returns the new path."""
    base = path.rstrip(os.sep)
    dest = base + ".quarantined"
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = f"{base}.quarantined.{n}"
    os.rename(base, dest)
    obs.REGISTRY.counter(
        "ckpt_quarantine_total", "checkpoints renamed out of the load path"
    ).inc()
    obs.get().event("ckpt_quarantine", path=path, dest=dest, reason=reason)
    if reason:
        try:
            with open(dest + ".reason" if os.path.isfile(dest)
                      else os.path.join(dest, "QUARANTINED"), "w") as f:
                f.write(reason + "\n")
        except OSError:
            pass  # the rename is the load-path fix; the note is best-effort
    return dest


def _dtype_name(dtype: torch.dtype) -> str:
    """The manifest's dtype name: ``float32``, ``bfloat16``."""
    return str(dtype).rpartition(".")[2]


def _to_saveable(t: torch.Tensor) -> np.ndarray:
    """The host array ``np.save`` writes for shard ``t``: np.save has no
    bfloat16, so bf16 goes as its bits in uint16, the JAX package's format
    (torch views bf16 as int16, NumPy that as uint16)."""
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).cpu().numpy().view(np.uint16)
    return t.detach().cpu().numpy()


def _to_tensor(arr: np.ndarray, dtype_str: str, device) -> torch.Tensor:
    """A shard read from disk (bf16 as its uint16 bits) as a tensor of its
    own on ``device``, in the manifest's dtype."""
    arr = np.ascontiguousarray(arr)
    if dtype_str == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.astype(np.dtype(dtype_str), copy=False))
    return t.to(device, copy=True)


def _shard_filename(start: Tuple[int, ...]) -> str:
    return "shard_" + "_".join(str(s) for s in start) + ".npy"


def _parse_shard_start(fn: str) -> Optional[Tuple[int, ...]]:
    """Inverse of ``_shard_filename``; None for files that aren't ours."""
    if not (fn.startswith("shard_") and fn.endswith(".npy")):
        return None
    try:
        return tuple(int(x) for x in fn[len("shard_"):-len(".npy")].split("_"))
    except ValueError:
        return None


def _index_start(index, shape) -> Tuple[int, ...]:
    return tuple(0 if sl.start is None else int(sl.start) for sl in index)


def _field_layout(u) -> Tuple[List[torch.Tensor], List[Tuple[int, ...]], Tuple[int, ...]]:
    """(shards, their origins in storage, the storage shape) of the port's
    field: a ``ShardedField`` (shards in rank order, equal local shapes),
    or one tensor."""
    if isinstance(u, torch.Tensor):
        return [u], [(0,) * u.dim()], tuple(u.shape)
    shards, mesh_shape = list(u.shards), tuple(u.mesh_shape)
    local = tuple(shards[0].shape)
    origins = [
        tuple(c * n for c, n in zip(coords_of_rank(r, mesh_shape), local))
        for r in range(len(shards))
    ]
    return shards, origins, tuple(p * n for p, n in zip(mesh_shape, local))


def save(path: str, u, step: int, extra: Optional[dict] = None,
         stats: Optional[dict] = None) -> None:
    """Write the field ``u`` at ``path`` (a directory): every shard, its
    checksum sidecar, then the manifest.

    Loads verify each shard against its ``<shard>.crc32`` sidecar and raise
    :class:`ShardCorruptError` on silent bit-rot. ``stats``, when given,
    gains ``shards``, ``bytes`` and the seconds of the device-to-host
    copies (``d2h_s``), the file writes (``write_s``) and the checksums
    (``crc_s``)."""
    with obs.get().span("ckpt_save", path=path, step=int(step)) as _sp:
        _save(path, u, step, extra, stats, _sp)
    obs.REGISTRY.counter("ckpt_writes_total", "checkpoint saves").inc()


def _save(path, u, step, extra, stats, _sp) -> None:
    shards, origins, shape = _field_layout(u)
    os.makedirs(path, exist_ok=True)
    # every stream of every device the shards are on: a shard's last update
    # may still run on its own stream
    for dev in {t.device for t in shards if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    nbytes = 0
    for t, start in zip(shards, origins):
        fn = _shard_filename(start)
        full = os.path.join(path, fn)
        with _timed(stats, "d2h_s"):
            saveable = _to_saveable(t)
        nbytes += saveable.nbytes
        # Crash-ordering: tmp-write the shard, UNLINK the old sidecar,
        # replace the shard, then write the new sidecar. Every kill window
        # degrades to "shard without sidecar" (loads unverified, like a
        # legacy checkpoint) — never to new-bytes-under-old-digest, which
        # would brand a good checkpoint corrupt on the next resume.
        tmp = full + ".tmp"
        with _timed(stats, "write_s"):
            with open(tmp, "wb") as f:
                np.save(f, saveable)  # file handle: np.save can't append .npy
            try:
                os.unlink(full + CRC_SUFFIX)
            except OSError:
                pass
            os.replace(tmp, full)
        with _timed(stats, "crc_s"):
            crc = _crc32_hex(saveable)
        crc_tmp = full + CRC_SUFFIX + ".tmp"
        with open(crc_tmp, "w") as f:
            f.write(crc)
        os.replace(crc_tmp, full + CRC_SUFFIX)
    # the FULL save layout, so a load ignores stale shard_*.npy files a
    # prior save on another mesh left in the same directory
    manifest = {
        "step": int(step),
        "global_shape": list(shape),
        "dtype": _dtype_name(shards[0].dtype),
        "format": 1,
        "checksums": "crc32-sidecar",
        "shards": [list(s) for s in sorted(set(origins))],
        "extra": extra or {},
    }
    tmp = os.path.join(path, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, os.path.join(path, MANIFEST))
    _sp.add(shards=len(shards), bytes=nbytes)
    if stats is not None:
        stats["shards"] = stats.get("shards", 0) + len(shards)
        stats["bytes"] = stats.get("bytes", 0) + nbytes


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def _saved_blocks(path: str, ndim: int, allowed=None):
    """Enumerate the saved shard blocks as (start, shape, filename).

    Shapes come from the .npy headers via mmap — no block data is read
    here (checksums are paid lazily, at first data read). ``allowed``
    (the manifest's recorded shard starts, when present) filters out
    stale shard files a prior save with a different mesh left in the
    directory; without it (pre-``shards`` manifests) every shard file is
    trusted."""
    blocks = []
    for fn in sorted(os.listdir(path)):
        start = _parse_shard_start(fn)
        if start is None or len(start) != ndim:
            continue
        if allowed is not None and start not in allowed:
            continue
        arr = np.load(os.path.join(path, fn), mmap_mode="r")
        blocks.append((start, arr.shape, fn))
    return blocks


def _read_block(path: str, fn: str, verified: Optional[set] = None, stats=None):
    """mmap-open the block ``fn`` and checksum-verify it once per load
    (``verified`` caches filenames across the shards of one restore, so a
    block feeding several stitched shards pays one crc pass)."""
    arr = np.load(os.path.join(path, fn), mmap_mode="r")
    if verified is None or fn not in verified:
        _maybe_verify(path, fn, arr, stats)
        if verified is not None:
            verified.add(fn)
    return arr


def _resolve_shard(path, shape, dtype_str, allowed, blocks, index, verified=None,
                   stats=None):
    """Read the shard ``index`` selects (as saved: raw bits for bf16), from
    its exactly-matching saved file when the manifest trusts it, else
    stitched from overlapping saved blocks. Returns ``(value, blocks)`` so
    the caller can reuse the lazily-scanned block list across shards.
    Every data read is checksum-verified (``verified`` caches block
    filenames already checked this restore)."""
    start = _index_start(index, shape)
    want = tuple(
        (0 if sl.stop is None else sl.stop) - (0 if sl.start is None else sl.start)
        for sl, n in zip(index, shape)
    )
    # normalize: slices with stop=None mean full axis
    want = tuple(
        n if (sl.start is None and sl.stop is None) else w
        for sl, n, w in zip(index, shape, want)
    )
    shard_fn = _shard_filename(start)
    fname = os.path.join(path, shard_fn)
    if (allowed is None or start in allowed) and os.path.exists(fname):
        # mmap probe: the header check must not pay a full read of a
        # wrong-shape block (the stitch below re-reads it lazily)
        arr = np.load(fname, mmap_mode="r")
        if arr.shape == want:
            with _timed(stats, "read_s"):
                data = np.array(arr)
            _maybe_verify(path, shard_fn, data, stats)
            return data, blocks
    # cross-mesh resume: stitch this shard from overlapping saved blocks
    if blocks is None:
        blocks = _saved_blocks(path, len(shape), allowed)
    out = None
    filled = np.zeros(want, dtype=bool)
    for bstart, bshape, bfn in blocks:
        lo = tuple(max(s, bs) for s, bs in zip(start, bstart))
        hi = tuple(
            min(s + w, bs + bw)
            for s, w, bs, bw in zip(start, want, bstart, bshape)
        )
        if any(lo_ >= hi_ for lo_, hi_ in zip(lo, hi)):
            continue
        arr = _read_block(path, bfn, verified, stats)
        if out is None:
            out = np.empty(want, dtype=arr.dtype)
        dst = tuple(slice(a - s, b - s) for a, b, s in zip(lo, hi, start))
        src = tuple(slice(a - b0, b - b0) for a, b, b0 in zip(lo, hi, bstart))
        with _timed(stats, "read_s"):
            out[dst] = arr[src]
        filled[dst] = True
    covered = int(np.count_nonzero(filled))  # mask: overlap-proof
    if covered != int(np.prod(want)):
        raise FileNotFoundError(
            f"checkpoint {path}: saved blocks cover {covered} of "
            f"{int(np.prod(want))} cells of the shard at {start} "
            f"(shape {want}) — shard files missing or not visible to "
            "this process (cross-mesh resume needs all overlapping "
            "blocks readable; consolidate multi-host shards first)"
        )
    return out, blocks


def load(path: str, mesh, stats: Optional[dict] = None):
    """Restore ``(field, step, extra)`` onto ``mesh`` (a
    ``parallel.topology.ShardMesh``): each shard read, verified and copied
    onto its shard's device; the field a tensor on a one-shard mesh, else a
    ``ShardedField``, in the manifest's dtype.

    The resume mesh does NOT need to match the save mesh: a shard is
    served by its exactly-matching saved file when one exists, and
    otherwise stitched from every saved block that overlaps it, so a run
    checkpointed on one decomposition (in either package) resumes on any
    other whose storage shape is the same. ``stats``, when given, gains
    the seconds of the file reads (``read_s``), the checksums (``crc_s``)
    and the host-to-device copies (``h2d_s``), and ``bytes``."""
    with obs.get().span("ckpt_load", path=path) as _sp:
        u, step, extra = _load(path, mesh, stats)
        _sp.add(step=step)
    return u, step, extra


def _load(path: str, mesh, stats: Optional[dict] = None):
    from heat3d_tpu_torch.models.heat3d import ShardedField

    manifest = load_manifest(path)
    shape = tuple(manifest["global_shape"])
    dtype_str = manifest["dtype"]
    stored = tuple(p * n for p, n in zip(mesh.shape, mesh.local_shape))
    if shape != stored:
        raise ValueError(
            f"checkpoint {path} holds a {shape} field; mesh {mesh.shape} of "
            f"{mesh.local_shape} blocks stores {stored}"
        )
    listed = manifest.get("shards")
    # Stale-shard gate: when the manifest records its save layout, ONLY
    # the listed starts may be trusted — shard files from an earlier save
    # on a different mesh match requested shapes exactly and would
    # otherwise be silently mixed into the restored field.
    allowed = {tuple(s) for s in listed} if listed else None

    zero = (0,) * len(shape)
    single = os.path.join(path, _shard_filename(zero))
    full = None
    if (allowed is None or zero in allowed) and os.path.exists(single):
        # mmap header probe: a partial zero block (every multi-shard save
        # has one) must not cost a full read just to fail the shape check
        arr = np.load(single, mmap_mode="r")
        if arr.shape == shape:
            with _timed(stats, "read_s"):
                full = np.array(arr)
            _maybe_verify(path, _shard_filename(zero), full, stats)
    blocks = None  # scanned lazily, only when a cross-mesh stitch is needed
    verified: set = set()
    us = []
    nbytes = 0
    for s in mesh.shards:
        index = tuple(slice(o, o + n) for o, n in zip(s.origin, mesh.local_shape))
        if full is not None:
            value = full[index]
        else:
            value, blocks = _resolve_shard(
                path, shape, dtype_str, allowed, blocks, index, verified, stats
            )
        with _timed(stats, "h2d_s"):
            us.append(_to_tensor(value, dtype_str, s.device))
        nbytes += value.nbytes
    if stats is not None:
        stats["bytes"] = stats.get("bytes", 0) + nbytes
    u = us[0] if len(us) == 1 else ShardedField(us, tuple(mesh.shape))
    return u, int(manifest["step"]), manifest.get("extra", {})


def consolidate(path: str, out_path: Optional[str] = None) -> str:
    """Merge a sharded checkpoint into a single-block one.

    Assembles the full field from the saved blocks (manifest-listed only,
    so stale files from older saves in the same directory are ignored),
    writes it as the one block a ``(0,...,0)`` start names, rewrites the
    manifest's ``shards`` accordingly, and deletes the now-redundant
    listed shard files. The result loads on any mesh through the
    single-block fast path.

    ``out_path`` writes the consolidated checkpoint elsewhere and leaves
    the input untouched. Returns the consolidated checkpoint directory.
    """
    manifest = load_manifest(path)
    shape = tuple(manifest["global_shape"])
    listed = manifest.get("shards")
    allowed = {tuple(s) for s in listed} if listed else None
    blocks = _saved_blocks(path, len(shape), allowed)
    if not blocks:
        raise FileNotFoundError(f"checkpoint {path}: no shard files found")
    zero_start = (0,) * len(shape)
    already_full = [
        b for b in blocks if b[0] == zero_start and b[1] == shape
    ]
    # A full-shape zero block beside still-listed partials USUALLY means a
    # consolidate crashed between its data replace and its manifest
    # replace, and this re-run is the recovery. But the same file shape
    # can be a STALE consolidated save in a directory a newer sharded
    # save's files were copied into (with the new zero partial missing) —
    # adopting that would resurrect old data and sweep the fresh partials.
    # Discriminate by content: a genuine recovery's full block was merged
    # FROM the surviving partials, so each must equal its region of it.
    if already_full:
        fullmap = np.load(
            os.path.join(path, already_full[0][2]), mmap_mode="r"
        )
        for bstart, bshape, bfn in blocks:
            if bstart == zero_start and bshape == shape:
                continue
            # same bounds check as the non-recovery branch: an out-of-range
            # block would make fullmap[region] silently clip below, and the
            # shape mismatch would then be misdiagnosed as a stale
            # consolidated save instead of a stale different-grid file
            hi = tuple(b + w for b, w in zip(bstart, bshape))
            if any(lo < 0 or h > n for lo, h, n in zip(bstart, hi, shape)):
                raise ValueError(
                    f"checkpoint {path}: block {bfn} spans {bstart}..{hi}, "
                    f"outside the manifest shape {shape} — stale file from "
                    "a different-grid save; remove it or list 'shards' in "
                    "the manifest"
                )
            region = tuple(
                slice(b, b + w) for b, w in zip(bstart, bshape)
            )
            part = np.load(os.path.join(path, bfn), mmap_mode="r")
            # equal_nan for float blocks (a diverged run's NaN cells must
            # not fail its own recovery); ints (raw bf16 views) compare
            # exactly and isnan would reject them
            eq_nan = np.issubdtype(part.dtype, np.inexact)
            if fullmap[region].shape != part.shape or not np.array_equal(
                fullmap[region], part, equal_nan=eq_nan
            ):
                raise ValueError(
                    f"checkpoint {path}: full-shape {already_full[0][2]} "
                    f"disagrees with listed partial {bfn} — the zero block "
                    "is a stale consolidated save, not this save's merge; "
                    "remove it (and re-copy the missing zero-start partial) "
                    "before consolidating"
                )
        del fullmap
        # partials beside the full block = a crash-recovery re-run: the
        # zero block's bytes were merged by the CRASHED run, so any
        # surviving sidecar predates them and is stale
        recovery_had_partials = len(blocks) > len(already_full)
        blocks = already_full
    else:
        recovery_had_partials = False
        # Coverage check done geometrically (clipped volumes + pairwise
        # overlap) rather than with a full-grid bool mask: at 4096^3 a mask
        # alone is 64 GiB of host RAM. Blocks reaching past the global
        # shape are rejected, not clipped — the assembly below writes whole
        # blocks.
        total = int(np.prod(shape))
        covered = 0
        clipped = []
        for bstart, bshape, bfn in blocks:
            lo, hi = bstart, tuple(b + w for b, w in zip(bstart, bshape))
            if any(a < 0 or h > n for a, h, n in zip(lo, hi, shape)):
                raise ValueError(
                    f"checkpoint {path}: block {bfn} spans {lo}..{hi}, "
                    f"outside the manifest shape {shape} — stale file from "
                    "a different-grid save; remove it or list 'shards' in "
                    "the manifest"
                )
            clipped.append((lo, hi))
            covered += int(np.prod([h - a for a, h in zip(lo, hi)]))
        for i in range(len(clipped)):
            for j in range(i + 1, len(clipped)):
                (alo, ahi), (blo, bhi) = clipped[i], clipped[j]
                if all(max(al, bl) < min(ah, bh)
                       for al, ah, bl, bh in zip(alo, ahi, blo, bhi)):
                    raise ValueError(
                        f"checkpoint {path}: saved blocks at {clipped[i][0]} "
                        f"and {clipped[j][0]} overlap — directory mixes saves "
                        "from different meshes; re-save or add a 'shards' "
                        "manifest"
                    )
        if covered != total:
            raise FileNotFoundError(
                f"checkpoint {path}: saved blocks cover {covered} of "
                f"{total} cells — copy every host's shard files "
                "into this directory before consolidating"
            )
    dest = out_path or path
    # realpath, not string, equality: `-o /ck/` (trailing slash, relative
    # spelling, symlink) naming the input must behave as in-place — delete
    # the replaced shard files — not as a broken hybrid of both modes
    in_place = os.path.realpath(dest) == os.path.realpath(path)
    os.makedirs(dest, exist_ok=True)
    zero_name = _shard_filename((0,) * len(shape))
    final = os.path.join(dest, zero_name)
    if not (already_full and in_place):
        tmp_data = final + ".tmp"
        # Assemble straight into an on-disk memmap (not host RAM — a
        # 4096^3 fp32 field is 256 GiB) under a .tmp name; os.replace
        # makes the data write as atomic as the manifest's, so a crash
        # mid-consolidation never leaves a truncated zero-block shadowing
        # good shard files.
        out = np.lib.format.open_memmap(
            tmp_data, mode="w+",
            dtype=np.load(
                os.path.join(path, blocks[0][2]), mmap_mode="r"
            ).dtype,
            shape=shape,
        )
        try:
            try:
                for bstart, bshape, bfn in blocks:
                    arr = _read_block(path, bfn)  # checksum-verified: never
                    # merge silent bit-rot into the consolidated block
                    dst = tuple(
                        slice(b, b + w) for b, w in zip(bstart, bshape)
                    )
                    out[dst] = arr
                out.flush()
            finally:
                del out
        except BaseException:
            # an aborted merge (e.g. a corrupt block failing its checksum)
            # must not leave the FULL-grid-sized .tmp memmap behind
            try:
                os.unlink(tmp_data)
            except OSError:
                pass
            raise
        # same crash-ordering as save(): drop any stale sidecar BEFORE the
        # bytes change, so a kill here degrades to "unverified", never to
        # new-bytes-under-old-digest
        try:
            os.unlink(final + CRC_SUFFIX)
        except OSError:
            pass
        os.replace(tmp_data, final)
    # The merged zero block needs a FRESH sidecar whenever its bytes (may)
    # have changed; the one case skipped is the pure no-op re-consolidate
    # (already-full, in place, no partials), whose sidecar is still valid.
    if not (already_full and in_place) or recovery_had_partials:
        crc_tmp = final + CRC_SUFFIX + ".tmp"
        with open(crc_tmp, "w") as f:
            f.write(_crc32_hex(np.load(final, mmap_mode="r")))
        os.replace(crc_tmp, final + CRC_SUFFIX)
    manifest["shards"] = [[0] * len(shape)]
    tmp = os.path.join(dest, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, os.path.join(dest, MANIFEST))
    # Source shards are deleted only after BOTH the data and manifest
    # replaces have landed — any earlier failure leaves the input loadable.
    # The sweep covers EVERY parseable shard file, not just manifest-listed
    # ones: after the replaces the manifest is the sole source of truth
    # ([[0,...,0]]), so unlisted files are dead weight the load path can
    # never read.
    if in_place:
        for fn in os.listdir(path):
            base = fn[: -len(CRC_SUFFIX)] if fn.endswith(CRC_SUFFIX) else fn
            # sidecars ride with their shard
            if base != zero_name and _parse_shard_start(base) is not None:
                os.remove(os.path.join(path, fn))
    return dest


def _cli(argv=None) -> int:
    """``python -m heat3d_tpu_torch.utils.checkpoint consolidate DIR [-o OUT]``."""
    import argparse

    p = argparse.ArgumentParser(
        prog="heat3d_tpu_torch.utils.checkpoint",
        description="checkpoint maintenance tools",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser(
        "consolidate", help="merge a sharded checkpoint into one block"
    )
    c.add_argument("path", help="checkpoint directory")
    c.add_argument(
        "-o", "--out", default=None,
        help="write the consolidated checkpoint here (default: in place)",
    )
    args = p.parse_args(argv)
    dest = consolidate(args.path, args.out)
    m = load_manifest(dest)
    print(
        f"consolidated {args.path} -> {dest}: step {m['step']}, "
        f"shape {tuple(m['global_shape'])}, dtype {m['dtype']}"
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_cli())
