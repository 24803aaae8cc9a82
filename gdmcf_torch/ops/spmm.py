"""Block-sparse SpMM: host builders, CUDA kernels and their plain versions.

Counterpart of the JAX package's ``ops/spmm.py``. The format is the same
block-CSR with a CSC view over the same tiles (see ``csrc/spmm.cu`` for the
layout); the TPU's ``[n_chunks, 8, 128]`` metadata chunking and ``_GROUP-1``
zero pad tiles existed for its DMA engine only, so the metadata here is flat
and the tile array holds exactly the stored tiles. One addition: each CSC
range is cut into segments of ``CSC_SEGMENT`` tiles, the transpose kernel's
unit of work.

Which path runs is decided by the operand's device alone: for CUDA tensors
``spmm`` launches the hand-written kernel (``spmm_csr_fwd`` forward,
``spmm_csc_t`` transpose) and raises if it cannot; for CPU tensors it runs
``spmm_reference``, the plain gather + einsum + ``index_add_`` version.

The kernels are compiled at first use with ``nvcc`` from ``csrc/spmm.cu``
into ``gdmcf_torch/_build/`` and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "spmm.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_MAX_TILE = 128  # the kernels hold at most 128 output rows per block
# CSC entries per transpose block: a hot column tile is spread over
# ceil(width / CSC_SEGMENT) blocks instead of serialising on one
CSC_SEGMENT = 64

# launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one exactly where it launches its kernel. A spmm_csc_t launch whose
# column tiles span several CSC segments is followed, in the same call, by
# spmm_csc_t_reduce_kernel, which sums the segment partials
LAUNCHES = {"spmm_csr_fwd": 0, "spmm_csc_t": 0}

_lib: Optional[ctypes.CDLL] = None
BUILD_LOG = ""


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# format
# ---------------------------------------------------------------------------

@dataclass
class BlockSparse:
    blocks: torch.Tensor          # [max(n_blocks, 1), br, bc] f32, CSR order
    block_cols: torch.Tensor      # [max(n_blocks, 1)] int32
    row_ptr: torch.Tensor         # [n_row_tiles + 1] int32
    col_ptr: torch.Tensor         # [n_col_tiles + 1] int32
    block_ids: torch.Tensor       # [max(n_blocks, 1)] int32, CSC -> CSR
    block_rows: torch.Tensor      # [max(n_blocks, 1)] int32, CSC order
    block_rows_csr: torch.Tensor  # [max(n_blocks, 1)] int32, CSR order
    seg_tile: torch.Tensor        # [n_seg] int32, column tile of a segment
    seg_start: torch.Tensor       # [n_seg] int32, its first CSC entry
    col_seg_ptr: torch.Tensor     # [n_col_tiles + 1] int32
    shape: Tuple[int, int]        # padded (n_rows, n_cols)
    br: int
    bc: int
    n_blocks: int
    max_row_width: int
    max_col_width: int

    _TENSORS = ("blocks", "block_cols", "row_ptr", "col_ptr", "block_ids",
                "block_rows", "block_rows_csr", "seg_tile", "seg_start",
                "col_seg_ptr")

    def to(self, device) -> "BlockSparse":
        kw = {f: getattr(self, f).to(device) for f in self._TENSORS}
        return BlockSparse(**kw, shape=self.shape, br=self.br, bc=self.bc,
                           n_blocks=self.n_blocks,
                           max_row_width=self.max_row_width,
                           max_col_width=self.max_col_width)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def n_segments(self) -> int:
        return self.seg_tile.shape[0]


def csc_segments(col_ptr: np.ndarray, seg_len: int = CSC_SEGMENT):
    """Cut each column tile's CSC range into segments of at most
    ``seg_len`` entries, at least one per column tile (so an empty column
    tile is written as zeros). Returns (seg_tile, seg_start, col_seg_ptr)."""
    widths = np.diff(col_ptr).astype(np.int64)
    counts = np.maximum(1, -(-widths // seg_len))
    col_seg_ptr = np.concatenate([[0], np.cumsum(counts)])
    seg_tile = np.repeat(np.arange(len(widths)), counts)
    seg_start = (col_ptr[seg_tile]
                 + (np.arange(len(seg_tile)) - col_seg_ptr[seg_tile])
                 * seg_len)
    return (seg_tile.astype(np.int32), seg_start.astype(np.int32),
            col_seg_ptr.astype(np.int32))


def degree_sort_permutation(mat: sp.spmatrix):
    """(row_perm, col_perm) sorting rows/cols by descending degree; apply
    with ``mat[row_perm][:, col_perm]``."""
    mat = mat.tocsr()
    row_deg = np.asarray(mat.sum(axis=1)).ravel()
    col_deg = np.asarray(mat.sum(axis=0)).ravel()
    return np.argsort(-row_deg), np.argsort(-col_deg)


def to_block_sparse(mat: sp.spmatrix, br: int = 128, bc: int = 128,
                    max_bytes: int = 8 << 30) -> BlockSparse:
    """Host-side: scipy sparse -> block-CSR (+CSC view), nonzero tiles only.

    Refuses (ValueError) when the densified tiles would exceed ``max_bytes``;
    duplicate COO entries are summed. Tensors are returned on the CPU.
    """
    mat = mat.tocoo()
    n_rows = -(-mat.shape[0] // br) * br
    n_cols = -(-mat.shape[1] // bc) * bc
    n_row_tiles = n_rows // br
    n_col_tiles = n_cols // bc
    tile_ids = (mat.row // br).astype(np.int64) * n_col_tiles + mat.col // bc
    uniq, inverse = np.unique(tile_ids, return_inverse=True)
    n_blocks = len(uniq)
    nbytes = max(n_blocks, 1) * br * bc * 4
    if nbytes > max_bytes:
        raise ValueError(
            f"block-sparse densification would take {nbytes / 2**30:.1f} GiB "
            f"({n_blocks} tiles for {mat.nnz} nnz, fill "
            f"{mat.nnz / max(n_blocks, 1) / (br * bc):.4f}); this format "
            "needs clustered sparsity — degree-sort the graph "
            "(degree_sort_permutation) or use to_hybrid")
    blocks = np.zeros((max(n_blocks, 1), br, bc), dtype=np.float32)
    np.add.at(blocks, (inverse.ravel(), mat.row % br, mat.col % bc),
              mat.data.astype(np.float32))
    u_rb = (uniq // n_col_tiles).astype(np.int32)
    u_cb = (uniq % n_col_tiles).astype(np.int32)

    def ptr(keys, n_bins):
        counts = np.bincount(keys, minlength=n_bins)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    row_ptr = ptr(u_rb, n_row_tiles)    # uniq is sorted by (row, col) tile
    csc_order = np.argsort(u_cb, kind="stable").astype(np.int32)
    col_ptr = ptr(u_cb, n_col_tiles)
    csc_rows = u_rb[csc_order]
    mrw = int(np.diff(row_ptr).max()) if n_blocks else 1
    mcw = int(np.diff(col_ptr).max()) if n_blocks else 1
    seg_tile, seg_start, col_seg_ptr = csc_segments(col_ptr)
    if n_blocks == 0:
        u_rb = u_cb = csc_order = csc_rows = np.zeros(1, np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return BlockSparse(
        blocks=t(blocks), block_cols=t(u_cb), row_ptr=t(row_ptr),
        col_ptr=t(col_ptr), block_ids=t(csc_order), block_rows=t(csc_rows),
        block_rows_csr=t(u_rb), seg_tile=t(seg_tile),
        seg_start=t(seg_start), col_seg_ptr=t(col_seg_ptr),
        shape=(n_rows, n_cols), br=br, bc=bc,
        n_blocks=n_blocks, max_row_width=max(mrw, 1),
        max_col_width=max(mcw, 1))


# ---------------------------------------------------------------------------
# plain version (any device)
# ---------------------------------------------------------------------------

def spmm_reference(a: BlockSparse, x: torch.Tensor,
                   transpose: bool = False) -> torch.Tensor:
    """Plain ``y = A @ x`` (or ``A^T @ x``): gather x tiles, one batched
    product per stored tile, segment-sum with ``index_add_``. Output rows
    are padded to the tile grid."""
    nb = a.n_blocks
    d = x.shape[1]
    x = x.float()
    if transpose:
        n_x, n_out, x_rows, out_tile = a.shape[0], a.shape[1], a.br, a.bc
        ids = a.block_ids[:nb].long()
        tiles = a.blocks[ids]
        x_idx = a.block_rows[:nb].long()
        seg = a.block_cols[ids].long()
        spec = "kij,kid->kjd"
    else:
        n_x, n_out, x_rows, out_tile = a.shape[1], a.shape[0], a.bc, a.br
        tiles = a.blocks[:nb]
        x_idx = a.block_cols[:nb].long()
        seg = a.block_rows_csr[:nb].long()
        spec = "kij,kjd->kid"
    x = x[:n_x]
    x_pad = x.new_zeros((n_x, d))
    x_pad[: x.shape[0]] = x
    gathered = x_pad.view(-1, x_rows, d)[x_idx]
    per_block = torch.einsum(spec, tiles, gathered)
    y = x.new_zeros((n_out // out_tile, out_tile, d))
    y.index_add_(0, seg, per_block)
    return y.view(n_out, d)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the SpMM kernels "
                           "are built from csrc/spmm.cu at first use")
    return found


def build_kernels() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    digest = hashlib.sha1(_SRC.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libgdmcf_spmm_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{BUILD_LOG}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gdmcf_spmm_csr_fwd.argtypes = [p, p, p, p, p, i, i, i, i, ll, p]
    lib.gdmcf_spmm_csr_fwd.restype = i
    lib.gdmcf_spmm_csc_t.argtypes = [p] * 10 + [i] * 6 + [ll, p]
    lib.gdmcf_spmm_csc_t.restype = i
    lib.gdmcf_spmm_error_string.argtypes = [i]
    lib.gdmcf_spmm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(lib, code: int, name: str) -> None:
    if code != 0:
        msg = lib.gdmcf_spmm_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")


def _launch(a: BlockSparse, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    if a.device != x.device:
        raise ValueError(f"operand on {a.device}, x on {x.device}")
    if a.br > _MAX_TILE or a.bc > _MAX_TILE:
        raise ValueError(f"tiles of {a.br}x{a.bc}: the kernels take "
                         f"br, bc <= {_MAX_TILE}")
    for name in BlockSparse._TENSORS:
        t = getattr(a, name)
        want = torch.float32 if name == "blocks" else torch.int32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {want}")
    x = x.contiguous()
    lib = build_kernels()
    d = x.shape[1]
    n_out = a.shape[1] if transpose else a.shape[0]
    with torch.cuda.device(x.device):
        y = torch.empty((n_out, d), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if transpose:
            n_col_tiles = a.shape[1] // a.bc
            # per-segment partials, only when some column tile has several
            part = (torch.empty((a.n_segments, a.bc, d), dtype=torch.float32,
                                device=x.device)
                    if a.n_segments > n_col_tiles else None)
            code = lib.gdmcf_spmm_csc_t(
                a.blocks.data_ptr(), a.block_ids.data_ptr(),
                a.block_rows.data_ptr(), a.col_ptr.data_ptr(),
                a.seg_tile.data_ptr(), a.seg_start.data_ptr(),
                a.col_seg_ptr.data_ptr(), x.data_ptr(), y.data_ptr(),
                None if part is None else part.data_ptr(), n_col_tiles,
                a.n_segments, CSC_SEGMENT, a.br, a.bc, d, x.shape[0], stream)
            _check(lib, code, "spmm_csc_t")
            LAUNCHES["spmm_csc_t"] += 1
        else:
            code = lib.gdmcf_spmm_csr_fwd(
                a.blocks.data_ptr(), a.block_cols.data_ptr(),
                a.row_ptr.data_ptr(), x.data_ptr(), y.data_ptr(),
                a.shape[0] // a.br, a.br, a.bc, d, x.shape[0], stream)
            _check(lib, code, "spmm_csr_fwd")
            LAUNCHES["spmm_csr_fwd"] += 1
    return y


def spmm(a: BlockSparse, x: torch.Tensor,
         transpose: bool = False) -> torch.Tensor:
    """``y = A @ x`` (or ``A^T @ x``), f32 accumulation.

    x: [A.shape[1] (or [0] for transpose), D]; fewer rows are accepted (the
    missing rows read as zero) and extra rows are dropped. Output rows are
    padded to the tile grid; slice to the logical size at the call site. A
    CUDA operand runs the kernel, a CPU operand the plain version.
    """
    n_x = a.shape[0] if transpose else a.shape[1]
    x = x.float()[:n_x]
    if x.is_cuda:
        return _launch(a, x, transpose)
    return spmm_reference(a, x, transpose)


# ---------------------------------------------------------------------------
# hybrid tile + COO remainder
# ---------------------------------------------------------------------------

@dataclass
class HybridSparse:
    """Tiles holding >= ``min_fill`` nonzeros ride the kernels; the
    stragglers are a COO list added with one ``index_add_``."""

    tiles: BlockSparse
    rem_rows: torch.Tensor  # [nnz_rem] int64 (row in A)
    rem_cols: torch.Tensor  # [nnz_rem] int64
    rem_vals: torch.Tensor  # [nnz_rem] float32

    def to(self, device) -> "HybridSparse":
        return HybridSparse(self.tiles.to(device), self.rem_rows.to(device),
                            self.rem_cols.to(device),
                            self.rem_vals.to(device))

    @property
    def device(self) -> torch.device:
        return self.tiles.device


def to_hybrid(mat: sp.spmatrix, br: int = 8, bc: int = 128,
              min_fill: int = 4, max_bytes: int = 8 << 30) -> HybridSparse:
    """scipy sparse -> HybridSparse (host-side, O(nnz), CPU tensors)."""
    coo = mat.tocoo()
    n_cols_pad = -(-coo.shape[1] // bc) * bc
    tile_id = ((coo.row // br).astype(np.int64) * (n_cols_pad // bc)
               + coo.col // bc)
    _, inverse, counts = np.unique(tile_id, return_inverse=True,
                                   return_counts=True)
    dense_mask = counts[inverse.ravel()] >= min_fill
    kept = sp.coo_matrix((coo.data[dense_mask],
                          (coo.row[dense_mask], coo.col[dense_mask])),
                         shape=coo.shape)
    tiles = to_block_sparse(kept, br, bc, max_bytes)
    rem = ~dense_mask
    return HybridSparse(
        tiles=tiles,
        rem_rows=torch.from_numpy(coo.row[rem].astype(np.int64)),
        rem_cols=torch.from_numpy(coo.col[rem].astype(np.int64)),
        rem_vals=torch.from_numpy(coo.data[rem].astype(np.float32)))


def _add_remainder(h: HybridSparse, y: torch.Tensor, x: torch.Tensor,
                   transpose: bool) -> torch.Tensor:
    rr, rc = (h.rem_cols, h.rem_rows) if transpose else (h.rem_rows,
                                                        h.rem_cols)
    return y.index_add_(0, rr, h.rem_vals[:, None] * x[rc])


def hybrid_spmm(h: HybridSparse, x: torch.Tensor,
                transpose: bool = False) -> torch.Tensor:
    """``y = A @ x`` (or ``A^T @ x``) on the hybrid format; output rows are
    padded to the tile grid. The tile part goes through ``spmm`` (kernel on
    CUDA); the COO remainder is one gather and ``index_add_``."""
    x = x.float()
    return _add_remainder(h, spmm(h.tiles, x, transpose), x, transpose)


def hybrid_spmm_reference(h: HybridSparse, x: torch.Tensor,
                          transpose: bool = False) -> torch.Tensor:
    """Plain ``hybrid_spmm`` on any device: the tiles through
    ``spmm_reference``, the remainder as in ``hybrid_spmm``."""
    x = x.float()
    return _add_remainder(h, spmm_reference(h.tiles, x, transpose), x,
                          transpose)
