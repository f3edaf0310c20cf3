"""Paged decode attention over a block-table KV cache (counterpart of
ray_tpu/ops/paged_attention.py).

Cache layout (per layer): ONE combined tensor

    kv_pages : [total_pages, page_size, 2 * num_kv_heads, head_dim]

with K at even and V at odd combined-head indices (k_h0, v_h0, k_h1, ...),
the JAX package's layout, so caches and prefill handoffs interchange with it.

- ``paged_decode_attention`` (also named ``paged_decode``, the kernel's name)
  wraps the CUDA kernel of ``csrc/paged_decode.cu``, which replaces the
  ragged paged attention kernel the JAX package takes from Pallas's library
  on the TPU: split-K over each slot's live pages (``decode_splits`` picks
  the split count from shapes alone), online softmax in fp32, the partials
  merged in split order inside the same launch.  On CPU tensors it takes
  the plain version; on CUDA tensors it launches the kernel or raises.
- ``_exact_path`` is the plain version, a torch copy of the JAX one: gather
  every page of the block table and run dense masked attention.
- ``_split_path`` is the kernel's split-and-merge in plain torch: per-split
  (m, l, acc) over the same page-aligned ranges, merged in split order.
  Tests use it; the main path does not.
"""

from __future__ import annotations

import ctypes
import math
import threading
import time

import torch

from . import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_GROUPS = (1, 2, 4, 8)
#: Blocks the split rule aims at for each SM, at most: on an H100 the
#: kernel's blocks (four warps, 64 KB of rings at D 128 bf16) ran fastest
#: at one to two an SM, a second wave or more merging costing more than it
#: spread.
BLOCKS_PER_SM = 2
#: A split takes at least this many pages of a slot, and at most
#: MAX_SPLITS splits share one (slot, KV head).  The kernel has the same
#: constants.
MIN_PAGES_PER_SPLIT = 2
MAX_SPLITS = 32


def combine_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Interleave per-head K and V ([..., Hkv, D] each) into the
    combined-head layout [..., 2*Hkv, D] the kernel reads."""
    stacked = torch.stack([k, v], dim=-2)          # [..., Hkv, 2, D]
    return stacked.reshape(*k.shape[:-2], 2 * k.shape[-2], k.shape[-1])


def _exact_path(q, kv_pages, block_table, seq_lens,
                page_size: int) -> torch.Tensor:
    """Plain version: gather each sequence's pages and run dense masked
    attention.  Materializes [B, H, S_max, D]."""
    B, H, D = q.shape
    Hkv = kv_pages.shape[2] // 2
    P = block_table.shape[1]
    group = H // Hkv
    pages = kv_pages[block_table.long()]          # [B, P, page, 2Hkv, D]
    k = pages[:, :, :, 0::2, :].reshape(B, P * page_size, Hkv, D)
    v = pages[:, :, :, 1::2, :].reshape(B, P * page_size, Hkv, D)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(),
                          k.float()) / math.sqrt(D)
    kv_pos = torch.arange(P * page_size, device=q.device)
    mask = kv_pos[None, :] < seq_lens[:, None]           # [B, S_max]
    scores = scores.masked_fill(~mask[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", probs, v.float())
    return out.to(q.dtype)


def decode_splits(B: int, Hkv: int, P: int, sm_count: int) -> int:
    """The kernel's split count, from shapes alone (never from seq_lens,
    which lie on the card): as many (slot, KV head, split) blocks as
    BLOCKS_PER_SM on every SM allow (so at least one on each), at most
    MAX_SPLITS, and never more than a table of P pages holds runs of
    MIN_PAGES_PER_SPLIT.  So B * Hkv * splits <= BLOCKS_PER_SM * sm_count
    wherever splits > 1: the workspace's size."""
    want = BLOCKS_PER_SM * sm_count // max(1, B * Hkv)
    return max(1, min(want, MAX_SPLITS, P // MIN_PAGES_PER_SPLIT))


def split_ranges(seq_lens, P: int, page_size: int, splits: int):
    """Each slot's token range [lo, hi) of every split, as the kernel
    works it out on the device: the live pages ceil(min(len, P*page) /
    page) cut into runs of max(MIN_PAGES_PER_SPLIT, ceil(live / splits))
    pages, run s to split s.  Returns (lo, hi), int64 [splits, B]; hi <= lo
    where a split's run is empty."""
    lens = seq_lens.long().clamp(min=0, max=P * page_size)
    live = -(-lens // page_size)
    pps = torch.clamp(-(-live // splits), min=MIN_PAGES_PER_SPLIT)
    s = torch.arange(splits, device=lens.device)[:, None]
    lo = s * pps[None] * page_size
    hi = torch.minimum(lens[None], (s + 1) * pps[None] * page_size)
    return lo, hi


def _split_partials(q, kv_pages, block_table, seq_lens, page_size: int,
                    splits: int):
    """Plain version of the kernel's splits: fp32 (m, l, acc) of every
    split over its range, [splits, B, H], [splits, B, H] and
    [splits, B, H, D]; an empty range gives m = -inf, l = 0, acc = 0."""
    B, H, D = q.shape
    Hkv = kv_pages.shape[2] // 2
    P = block_table.shape[1]
    group = H // Hkv
    pages = kv_pages[block_table.long()].float()  # [B, P, page, 2Hkv, D]
    k = pages[:, :, :, 0::2, :].reshape(B, P * page_size, Hkv, D)
    v = pages[:, :, :, 1::2, :].reshape(B, P * page_size, Hkv, D)
    k = k.transpose(1, 2).repeat_interleave(group, dim=1)
    v = v.transpose(1, 2).repeat_interleave(group, dim=1)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), k) / math.sqrt(D)
    pos = torch.arange(P * page_size, device=q.device)
    lo, hi = split_ranges(seq_lens, P, page_size, splits)
    ms, ls, accs = [], [], []
    for s in range(splits):
        inside = (pos[None] >= lo[s][:, None]) & (pos[None] < hi[s][:, None])
        sc = scores.masked_fill(~inside[:, None, :], -math.inf)
        m = sc.amax(dim=-1)                                  # [B, H]
        p = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhk,bhkd->bhd", p, v))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def _merge_partials(m, l, acc, dtype) -> torch.Tensor:
    """The kernel's merge: partials rescaled to their common max and
    summed in split order; a slot with no partial gives zeros."""
    top = m.amax(dim=0)
    top = torch.where(torch.isinf(top), 0.0, top)
    lsum = torch.zeros_like(l[0])
    osum = torch.zeros_like(acc[0])
    for s in range(m.shape[0]):
        f = torch.exp(m[s] - top)                   # 0 for an empty split
        lsum = lsum + l[s] * f
        osum = osum + acc[s] * f[..., None]
    out = osum / torch.where(lsum > 0, lsum, 1.0)[..., None]
    return out.to(dtype)


def _split_path(q, kv_pages, block_table, seq_lens, page_size: int,
                splits: int):
    """The kernel's split-and-merge in plain torch (inactive slots give
    zeros, as the kernel's do)."""
    return _merge_partials(*_split_partials(q, kv_pages, block_table,
                                            seq_lens, page_size, splits),
                           q.dtype)


def _check_paged(q, kv_pages, block_table, seq_lens, page_size) -> None:
    dev = q.device
    for name, t in (("q", q), ("kv_pages", kv_pages),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"paged_decode: {name} must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode: {name} must be 16-byte "
                             f"aligned")
    if q.dtype not in _DTYPE_CODE or kv_pages.dtype != q.dtype:
        raise ValueError(f"paged_decode takes q and kv_pages of one dtype, "
                         f"bfloat16 or float32; got {q.dtype} / "
                         f"{kv_pages.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("paged_decode: block_table and seq_lens must be "
                         "int32")
    if q.dim() != 3 or kv_pages.dim() != 4:
        raise ValueError(f"paged_decode: q [B, H, D] and kv_pages "
                         f"[NP, page, 2*Hkv, D] expected; got "
                         f"{tuple(q.shape)} / {tuple(kv_pages.shape)}")
    B, H, D = q.shape
    if page_size < 1 or B < 1 or block_table.dim() != 2 \
            or block_table.shape[1] < 1:
        raise ValueError(f"paged_decode: page_size >= 1, B >= 1 and a "
                         f"block table of >= 1 page expected; got "
                         f"page_size={page_size}, q {tuple(q.shape)}, "
                         f"block_table {tuple(block_table.shape)}")
    if kv_pages.shape[1] != page_size or kv_pages.shape[3] != D \
            or kv_pages.shape[2] % 2:
        raise ValueError(f"paged_decode: kv_pages {tuple(kv_pages.shape)} "
                         f"does not match page_size={page_size}, D={D}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode takes head_dim in {_HEAD_DIMS}, "
                         f"not {D}")
    Hkv = kv_pages.shape[2] // 2
    if H % Hkv or H // Hkv not in _GROUPS:
        raise ValueError(f"paged_decode takes H/Hkv in {_GROUPS}; got "
                         f"H={H}, Hkv={Hkv}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"paged_decode: block_table [B, P] and seq_lens "
                         f"[B] expected for B={B}; got "
                         f"{tuple(block_table.shape)} / "
                         f"{tuple(seq_lens.shape)}")


_SM_COUNT = {}
#: (device, stream handle) -> (the kernel's workspace for launches on that
#: stream, the split blocks it holds).
_WORKSPACE = {}
#: (device, stream handle, dtype, B, H, Hkv, D, P, page_size) -> (its
#: prepared _Launch, the _Launch's address, which every call passes).
_LAUNCH = {}
_FN = []
#: Creates every entry of _WORKSPACE, _LAUNCH and _FN.  Threads that miss
#: a cache at once (serving replicas making their first decode together)
#: must not each insert: the second insert would free the first entry
#: while its maker still passes its address to the kernel.  So an entry
#: is made under this lock, after a second look, and the first one made
#: is kept for good.  Reads of an existing entry need no lock.
_CACHE_LOCK = threading.RLock()


def _sm_count(device) -> int:
    """The card's SM count, asked once per device."""
    n = _SM_COUNT.get(device)
    if n is None:
        n = _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _splits(device, B: int, Hkv: int, P: int) -> int:
    """The kernel's split count on ``device`` (decode_splits)."""
    return decode_splits(B, Hkv, P, _sm_count(device))


def _workspace(device, stream: int) -> tuple:
    """(the kernel's workspace for launches on ``stream`` of ``device``,
    the split blocks it holds).

    The split rule keeps B * Hkv * splits within blocks = BLOCKS_PER_SM *
    SMs wherever splits > 1, so B * Hkv within blocks // 2: the workspace
    holds blocks // 2 int32 arrival counters, then blocks partials of the
    largest G * (D + 2) floats (about 1.1 MB on an H100).  There is one per
    stream: launches on one stream run in order, so they may share its
    counters and partials, while two launches in flight on two streams
    never do.  Each is allocated with zeros at the first launch on its
    stream, every launch leaves its counters 0 again, and it is never freed
    or replaced, so a CUDA graph that captured its address stays right.

    It is never allocated while the stream is capturing a CUDA graph: the
    zero-fill would be captured into the graph, and the memory would come
    from the graph's private pool.  Such a capture raises; one call on the
    capture stream before the capture (the warm-up PyTorch asks for
    anyway) allocates it."""
    key = (device, stream)
    hit = _WORKSPACE.get(key)
    if hit is not None:
        return hit
    with _CACHE_LOCK:
        hit = _WORKSPACE.get(key)
        if hit is not None:
            return hit
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_decode: this stream has no workspace yet, and it is "
                "not allocated during a CUDA graph capture; call "
                "paged_decode once on the capture stream before capturing "
                "(e.g. s = torch.cuda.Stream(); with torch.cuda.stream(s): "
                "<warm-up call>; then torch.cuda.graph(g, stream=s))")
        blocks = BLOCKS_PER_SM * _sm_count(device)
        part = max(_GROUPS) * (max(_HEAD_DIMS) + 2)
        hit = _WORKSPACE[key] = (
            torch.zeros(blocks // 2 + blocks * part, dtype=torch.float32,
                        device=device), blocks)
        return hit


class _Launch(ctypes.Structure):
    """csrc/paged_decode.cu's struct Launch: rt_paged_decode's arguments
    that depend on shapes alone, built once per (device, shape);
    rt_paged_decode_prepare fills smem and scale_log2."""
    _fields_ = [("ws", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("ws_blocks", "dtype", "B", "H", "Hkv",
                                    "D", "P", "page_size", "splits",
                                    "smem")] + [
        ("scale_log2", ctypes.c_float)]


def _kernel_fn():
    if not _FN:
        with _CACHE_LOCK:
            if not _FN:
                _FN.append(_build.function(
                    "paged_decode", "rt_paged_decode",
                    [ctypes.c_void_p] * 7))
    return _FN[0]


def _launch(device, stream, dtype, B, H, Hkv, D, P, page_size) -> int:
    """The address of the prepared _Launch of this shape on ``stream`` of
    ``device`` (the current device): the stream's workspace and its split
    blocks (none and 0 at one split), dtype, the shapes and the split
    count."""
    key = (device, stream, dtype, B, H, Hkv, D, P, page_size)
    with _CACHE_LOCK:
        hit = _LAUNCH.get(key)
        if hit is not None:
            return hit[1]
        t0 = time.perf_counter()
        splits = _splits(device, B, Hkv, P)
        ws, blocks = _workspace(device, stream) if splits > 1 else (None, 0)
        launch = _Launch(None if ws is None else ws.data_ptr(), blocks,
                         _DTYPE_CODE[dtype], B, H, Hkv, D, P, page_size,
                         splits)
        prepare = _build.function("paged_decode", "rt_paged_decode_prepare",
                                  [ctypes.c_void_p])
        _build.check("paged_decode", prepare(ctypes.addressof(launch)),
                     "paged_decode prepare")
        hit = _LAUNCH[key] = (launch, ctypes.addressof(launch))
        if _build.compile_listener is not None:
            _build.compile_listener("launch", "paged_decode",
                                    time.perf_counter() - t0)
        return hit[1]


def _kernel_args(q, kv_pages, block_table, seq_lens, page_size, out):
    """rt_paged_decode's arguments for one call (on q's device, current,
    and its current stream)."""
    B, H, D = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    key = (q.device, stream, q.dtype, B, H, kv_pages.shape[2] // 2, D,
           block_table.shape[1], page_size)
    hit = _LAUNCH.get(key)
    return (q.data_ptr(), kv_pages.data_ptr(), block_table.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(),
            hit[1] if hit is not None else _launch(*key), stream)


def paged_decode_attention(q, kv_pages, block_table, seq_lens,
                           page_size: int) -> torch.Tensor:
    """One decode step of attention over the paged cache.

    q: [B, H, D] (one new token per slot); kv_pages: [NP, page, 2*Hkv, D]
    combined; block_table: [B, P] int32 page ids; seq_lens: [B] int32
    sequence length INCLUDING the new token (0 = inactive slot, whose
    output is zeros).  Returns [B, H, D] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one launch a call) or raise.  ``paged_decode_attention.launches``
    counts kernel launches, ``.launches_by_thread`` them by the launching
    thread's name."""
    if q.device.type == "cpu":
        return _exact_path(q, kv_pages, block_table, seq_lens, page_size)
    _check_paged(q, kv_pages, block_table, seq_lens, page_size)
    out = torch.empty_like(q)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        code = fn(*_kernel_args(q, kv_pages, block_table, seq_lens,
                                page_size, out))
    _build.check("paged_decode", code, "paged_decode launch")
    _build.count_launch(paged_decode_attention)
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_thread = {}
#: The kernel's own name: the same function, and the same launch count.
paged_decode = paged_decode_attention
