"""Sparse products for LightGCN: host builders, the CUDA kernel and its plain
version.

Counterpart of the JAX package's ``ops/spmm.py``. The tile format is the
same block-CSR with a CSC view over the same tiles; the TPU's
``[n_chunks, 8, 128]`` metadata chunking and ``_GROUP-1`` zero pad tiles
existed for its DMA engine only, so the metadata here is flat and the tile
array holds exactly the stored tiles. The tiles and ``spmm_reference`` /
``hybrid_spmm_reference`` keep the TPU's structure as references.

What the products run on is a ``RowOperand`` per direction, built beside
the tiles: a CSR over the padded output rows holding only the nonzeros (the
transpose gets its own CSR of A^T), each row's range cut into segments of at
most ``ROW_SEGMENT`` nonzeros, the kernel's unit of work. A
``BlockSparse`` reads the operands of its tiles' nonzeros from the tiles at
first use; a ``HybridSparse`` carries operands over all its nonzeros, tiles
and COO remainder together, so a hybrid product is one launch.

Which path runs is decided by the tensors' device alone: for CUDA tensors
``spmm_rows`` (and ``spmm``, ``hybrid_spmm``) launches the hand-written
kernel (counted as ``spmm_rows_fwd`` or ``spmm_rows_t``) and raises if it
cannot; for CPU tensors it runs ``spmm_rows_reference``, the plain gather,
scale and ``index_add_`` over the same operand and segments.

The differentiable product is ``spmm_op`` (the JAX package's ``spmm_op``
custom VJP): a ``torch.autograd.Function`` over the pair of row operands of
one matrix, whose backward pass is the same product in the other direction
on the other operand, ``A^T g``. It runs on both devices, so the CPU takes
the same backward structure as the card. ``spmm``, ``hybrid_spmm`` and the
propagations of ``models/lightgcn`` go through it.

The kernel is compiled at first use with ``nvcc`` from ``csrc/spmm.cu``
into ``gdmcf_torch/_build/`` and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch.distributed.tensor import DTensor

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "spmm.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# nonzeros per kernel warp: a hot row (34,681 nonzeros in the Amazon-Book
# transpose) is spread over ceil(width / ROW_SEGMENT) warps instead of
# serialising on one. 128 gave the least time over both directions in
# the sweep of chip_smoke.py --profile at the Amazon-Book size (PERF.md)
ROW_SEGMENT = 128

# launches of the kernel per direction since the last reset_launch_counts();
# the wrapper adds one exactly where it launches the kernel
LAUNCHES = {"spmm_rows_fwd": 0, "spmm_rows_t": 0}

_lib: Optional[ctypes.CDLL] = None
BUILD_LOG = ""


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# row operand
# ---------------------------------------------------------------------------

@dataclass
class RowOperand:
    """One direction of a product, y[r] = sum_k vals[k] * x[cols[k]] over
    row r's range: a CSR over the padded output rows, duplicates summed,
    zero values dropped, every row present (an empty row gives zeros)."""

    row_ptr: torch.Tensor      # [n_out + 1] int32
    cols: torch.Tensor         # [nnz] int32, the x row of each nonzero
    vals: torch.Tensor         # [nnz] float32
    seg_ptr: torch.Tensor      # [n_seg + 1] int32, a segment's nonzeros
    seg_row: torch.Tensor      # [n_seg] int32, the output row of a segment
    seg_part: torch.Tensor     # [n_seg] int32, partial slot; -1 for a row
    #                            of one segment, which writes y directly
    row_seg_ptr: torch.Tensor  # [n_out + 1] int32, the segments of a row
    n_part: int
    transpose: bool

    _TENSORS = ("row_ptr", "cols", "vals", "seg_ptr", "seg_row", "seg_part",
                "row_seg_ptr")

    def to(self, device) -> "RowOperand":
        kw = {f: getattr(self, f).to(device) for f in self._TENSORS}
        return RowOperand(**kw, n_part=self.n_part, transpose=self.transpose)

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def n_out(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.cols.shape[0]

    @property
    def n_seg(self) -> int:
        return self.seg_row.shape[0]

    def resegment(self, seg_len: int) -> "RowOperand":
        """The same nonzeros cut into segments of at most ``seg_len``."""
        segs = row_segments(self.row_ptr.cpu().numpy(), seg_len)
        return RowOperand(
            self.row_ptr, self.cols, self.vals,
            *(torch.from_numpy(a).to(self.device) for a in segs),
            n_part=int((segs[2] >= 0).sum()), transpose=self.transpose)


def row_segments(row_ptr: np.ndarray, seg_len: int = ROW_SEGMENT):
    """Cut each row's range into segments of at most ``seg_len`` nonzeros,
    at least one per row. Returns (seg_ptr, seg_row, seg_part,
    row_seg_ptr): segment ``row_seg_ptr[r] + i`` is the i-th of row r and
    covers ``[seg_ptr[s], seg_ptr[s + 1])``, from ``row_ptr[r] + i *
    seg_len``; the segments of a row of several get consecutive partial
    slots, the others -1."""
    if seg_len < 1:
        raise ValueError(f"seg_len {seg_len} must be at least 1")
    row_ptr = np.asarray(row_ptr, np.int64)
    widths = np.diff(row_ptr)
    counts = np.maximum(1, -(-widths // seg_len))
    row_seg_ptr = np.concatenate([[0], np.cumsum(counts)])
    seg_row = np.repeat(np.arange(len(widths)), counts)
    seg_ptr = np.append(row_ptr[seg_row] + (np.arange(len(seg_row))
                                            - row_seg_ptr[seg_row]) * seg_len,
                        row_ptr[-1])
    multi = counts[seg_row] > 1
    seg_part = np.where(multi, np.cumsum(multi) - 1, -1)
    return tuple(a.astype(np.int32)
                 for a in (seg_ptr, seg_row, seg_part, row_seg_ptr))


def row_operand(csr: sp.csr_matrix, transpose: bool) -> RowOperand:
    """A scipy CSR (duplicates summed, indices sorted) -> RowOperand (CPU
    tensors); entries of value 0 are dropped."""
    csr = csr.copy()
    csr.eliminate_zeros()
    if csr.nnz >= 2**31 - 64:
        raise ValueError(f"{csr.nnz} nonzeros: the operand indexes them "
                         "with int32")
    segs = row_segments(csr.indptr)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))

    return RowOperand(
        t(csr.indptr, np.int32), t(csr.indices, np.int32),
        t(csr.data, np.float32), *(torch.from_numpy(a) for a in segs),
        n_part=int((segs[2] >= 0).sum()), transpose=transpose)


def row_operands(csr: sp.csr_matrix) -> Tuple[RowOperand, RowOperand]:
    """The forward and the transpose operand of a canonical float32 CSR
    over the padded grid."""
    return row_operand(csr, False), row_operand(csr.T.tocsr(), True)


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
    shape: Tuple[int, int]        # padded (n_rows, n_cols)
    br: int
    bc: int
    n_blocks: int
    max_row_width: int
    max_col_width: int
    # (A, A^T) row operands of the tiles' nonzeros, built at first use
    _rows: Optional[Tuple[RowOperand, RowOperand]] = field(
        default=None, repr=False, compare=False)

    _TENSORS = ("blocks", "block_cols", "row_ptr", "col_ptr", "block_ids",
                "block_rows", "block_rows_csr")

    def to(self, device) -> "BlockSparse":
        kw = {f: getattr(self, f).to(device) for f in self._TENSORS}
        rows = (None if self._rows is None
                else tuple(op.to(device) for op in self._rows))
        return BlockSparse(**kw, shape=self.shape, br=self.br, bc=self.bc,
                           n_blocks=self.n_blocks,
                           max_row_width=self.max_row_width,
                           max_col_width=self.max_col_width, _rows=rows)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def fwd_rows(self) -> RowOperand:
        """The tiles' nonzeros as the row operand of A."""
        return self._row_operands()[0]

    @property
    def t_rows(self) -> RowOperand:
        """The tiles' nonzeros as the row operand of A^T."""
        return self._row_operands()[1]

    def _row_operands(self) -> Tuple[RowOperand, RowOperand]:
        if self._rows is None:
            # every stored entry once, its value as the tile holds it
            blocks = self.blocks[:self.n_blocks].cpu().numpy()
            b, i, j = np.nonzero(blocks)
            rows = self.block_rows_csr.cpu().numpy()[b] * self.br + i
            cols = self.block_cols.cpu().numpy()[b] * self.bc + j
            csr = sp.csr_matrix((blocks[b, i, j], (rows, cols)),
                                shape=self.shape)
            self._rows = tuple(op.to(self.device)
                               for op in row_operands(csr))
        return self._rows


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
    The row operands of the tiles' nonzeros (``fwd_rows``, ``t_rows``) are
    read from the tiles at first use, so every path multiplies the same
    float32 numbers.

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
    inverse = inverse.ravel()
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
    np.add.at(blocks, (inverse, mat.row % br, mat.col % bc),
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
    if n_blocks == 0:
        u_rb = u_cb = csc_order = csc_rows = np.zeros(1, np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return BlockSparse(
        blocks=t(blocks), block_cols=t(u_cb), row_ptr=t(row_ptr),
        col_ptr=t(col_ptr), block_ids=t(csc_order), block_rows=t(csc_rows),
        block_rows_csr=t(u_rb), shape=(n_rows, n_cols), br=br, bc=bc,
        n_blocks=n_blocks, max_row_width=max(mrw, 1),
        max_col_width=max(mcw, 1))


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------

def spmm_reference(a: BlockSparse, x: torch.Tensor,
                   transpose: bool = False) -> torch.Tensor:
    """Plain ``y = A @ x`` (or ``A^T @ x``) in the TPU kernels' structure:
    gather x tiles, one batched product per stored tile, segment-sum with
    ``index_add_``. Output rows are padded to the tile grid."""
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


def spmm_rows_reference(op: RowOperand, x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: gather the x rows of the nonzeros, scale
    by their values, ``index_add_`` them into per-segment partials (the
    kernel's warps), then the partials into their rows. Nonzeros whose x
    row is past ``x.shape[0]`` read as zero; y has ``op.n_out`` rows."""
    x = x.float()
    d = x.shape[1]
    seg = torch.repeat_interleave(
        torch.arange(op.n_seg, device=op.device),
        (op.seg_ptr[1:] - op.seg_ptr[:-1]).long())
    cols = op.cols.long()
    keep = cols < x.shape[0]
    part = x.new_zeros((op.n_seg, d)).index_add_(
        0, seg[keep], op.vals[keep, None] * x[cols[keep]])
    return x.new_zeros((op.n_out, d)).index_add_(0, op.seg_row.long(), part)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the SpMM kernel "
                           "is built from csrc/spmm.cu at first use")
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
    lib.gdmcf_spmm_rows.argtypes = [p] * 10 + [i] * 3 + [ll, p]
    lib.gdmcf_spmm_rows.restype = i
    lib.gdmcf_spmm_error_string.argtypes = [i]
    lib.gdmcf_spmm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(lib, code: int, name: str) -> None:
    if code != 0:
        msg = lib.gdmcf_spmm_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")


def _launch(op: RowOperand, x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"x must be [n, D], got shape {tuple(x.shape)}")
    for name in RowOperand._TENSORS:
        t = getattr(op, name)
        want = torch.float32 if name == "vals" else torch.int32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {want}")
    x = x.contiguous()
    lib = build_kernels()
    d = x.shape[1]
    name = "spmm_rows_t" if op.transpose else "spmm_rows_fwd"
    with torch.cuda.device(x.device):
        y = torch.empty((op.n_out, d), dtype=torch.float32, device=x.device)
        part = count = None
        if op.n_part:   # partials of the rows cut into several segments
            part = torch.empty((op.n_part, d), dtype=torch.float32,
                               device=x.device)
            count = torch.zeros(op.n_part, dtype=torch.int32,
                                device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.gdmcf_spmm_rows(
            op.cols.data_ptr(), op.vals.data_ptr(), op.seg_ptr.data_ptr(),
            op.seg_row.data_ptr(), op.seg_part.data_ptr(),
            op.row_seg_ptr.data_ptr(), x.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(),
            None if count is None else count.data_ptr(),
            op.n_seg, op.n_part, d, x.shape[0], stream)
        _check(lib, code, name)
        LAUNCHES[name] += 1
    return y


def spmm_rows(op: RowOperand, x: torch.Tensor) -> torch.Tensor:
    """``y = op @ x``, f32 accumulation, ``op.n_out`` rows. x may hold
    fewer rows than the operand's columns (the missing rows read as zero)
    or more (never read). A CUDA x runs the kernel, a CPU x the plain
    version. Not differentiable: an x that needs a gradient raises (the
    differentiable product is ``spmm_op``)."""
    if isinstance(x, DTensor):
        raise TypeError("spmm_rows takes a rank's local tensor, not a "
                        "DTensor: pass x.to_local()")
    if op.device != x.device:
        raise ValueError(f"operand on {op.device}, x on {x.device}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("x requires grad: spmm_rows has no backward pass; "
                         "use spmm_op(op, op_opposite, x)")
    x = x.float()
    if x.is_cuda:
        return _launch(op, x)
    return spmm_rows_reference(op, x)


class _SpmmOp(torch.autograd.Function):
    """y = op @ x; the gradient of x is op_opposite @ g, the same kernel
    on the operand of the other direction. The graph gets no gradient."""

    @staticmethod
    def forward(ctx, x, op, op_opposite):
        ctx.op_opposite = op_opposite
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return spmm_rows(op, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        # g has the padded output rows of op (their cotangents are zero);
        # the result has op_opposite's padded rows: cut (or, for an x with
        # rows the product never read, pad) it to x's rows
        gx = spmm_rows(ctx.op_opposite, g)
        n_x = ctx.x_shape[0]
        if gx.shape[0] >= n_x:
            gx = gx[:n_x]
        else:
            gx = torch.cat([gx, gx.new_zeros((n_x - gx.shape[0],
                                              gx.shape[1]))])
        return gx.to(ctx.x_dtype), None, None


def spmm_op(op: RowOperand, op_opposite: RowOperand,
            x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``y = op @ x``: ``op`` and ``op_opposite`` are the
    two row operands of one matrix (``fwd_rows``/``t_rows`` of a
    ``BlockSparse`` or ``HybridSparse``, either way round). The forward
    pass is one ``spmm_rows``, the backward pass one ``spmm_rows`` on
    ``op_opposite``: on CUDA each launches the kernel or raises."""
    if op.transpose == op_opposite.transpose or op.device != op_opposite.device:
        raise ValueError("op_opposite must be the other direction's operand "
                         "on the same device")
    return _SpmmOp.apply(x, op, op_opposite)


def spmm(a: BlockSparse, x: torch.Tensor,
         transpose: bool = False) -> torch.Tensor:
    """``y = A @ x`` (or ``A^T @ x``) over the tiles' nonzeros,
    differentiable in x.

    x: [A.shape[1] (or [0] for transpose), D]; fewer rows are accepted (the
    missing rows read as zero) and extra rows are dropped. Output rows are
    padded to the tile grid; slice to the logical size at the call site. A
    CUDA operand runs the kernel, a CPU operand the plain version.
    """
    ops = (a.t_rows, a.fwd_rows) if transpose else (a.fwd_rows, a.t_rows)
    return spmm_op(*ops, x)


# ---------------------------------------------------------------------------
# hybrid tile + COO remainder
# ---------------------------------------------------------------------------

@dataclass
class HybridSparse:
    """The JAX package's hybrid format: tiles holding >= ``min_fill``
    nonzeros and a COO list of the stragglers, the TPU-structured
    reference. ``fwd_rows``/``t_rows`` hold all the nonzeros, tiles and
    remainder together; the products run on them."""

    tiles: BlockSparse
    rem_rows: torch.Tensor  # [nnz_rem] int64 (row in A)
    rem_cols: torch.Tensor  # [nnz_rem] int64
    rem_vals: torch.Tensor  # [nnz_rem] float32
    fwd_rows: RowOperand
    t_rows: RowOperand

    def to(self, device) -> "HybridSparse":
        return HybridSparse(self.tiles.to(device), self.rem_rows.to(device),
                            self.rem_cols.to(device),
                            self.rem_vals.to(device),
                            self.fwd_rows.to(device), self.t_rows.to(device))

    @property
    def device(self) -> torch.device:
        return self.tiles.device


def to_hybrid(mat: sp.spmatrix, br: int = 8, bc: int = 128,
              min_fill: int = 4, max_bytes: int = 8 << 30) -> HybridSparse:
    """scipy sparse -> HybridSparse (host-side, O(nnz log nnz), CPU
    tensors)."""
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
    rem_rows = coo.row[rem].astype(np.int64)
    rem_cols = coo.col[rem].astype(np.int64)
    rem_vals = coo.data[rem].astype(np.float32)
    # the whole operand, duplicates summed in float32; an entry of a kept
    # tile (membership goes by tile) takes the value the tile holds
    csr = sp.csr_matrix((coo.data.astype(np.float32), (coo.row, coo.col)),
                        shape=tiles.shape)
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    n_col_tiles = tiles.shape[1] // bc
    stored = (tiles.block_rows_csr.numpy()[:tiles.n_blocks].astype(np.int64)
              * n_col_tiles + tiles.block_cols.numpy()[:tiles.n_blocks])
    key = (rows // br) * n_col_tiles + csr.indices // bc
    pos = np.minimum(np.searchsorted(stored, key), max(tiles.n_blocks - 1, 0))
    hit = stored[pos] == key if tiles.n_blocks else np.zeros(len(key), bool)
    csr.data[hit] = tiles.blocks.numpy()[pos[hit], rows[hit] % br,
                                         csr.indices[hit] % bc]
    fwd_rows, t_rows = row_operands(csr)
    return HybridSparse(
        tiles=tiles, rem_rows=torch.from_numpy(rem_rows),
        rem_cols=torch.from_numpy(rem_cols),
        rem_vals=torch.from_numpy(rem_vals),
        fwd_rows=fwd_rows, t_rows=t_rows)


def hybrid_spmm(h: HybridSparse, x: torch.Tensor,
                transpose: bool = False) -> torch.Tensor:
    """``y = A @ x`` (or ``A^T @ x``) over all of the hybrid's nonzeros,
    differentiable in x: one kernel launch on CUDA (and one in the
    backward pass), the plain version on the CPU. Output rows are padded
    to the tile grid."""
    ops = (h.t_rows, h.fwd_rows) if transpose else (h.fwd_rows, h.t_rows)
    return spmm_op(*ops, x)


def hybrid_spmm_reference(h: HybridSparse, x: torch.Tensor,
                          transpose: bool = False) -> torch.Tensor:
    """Plain ``hybrid_spmm`` in the JAX package's structure, on any device:
    the tiles through ``spmm_reference``, then the COO remainder as one
    gather and ``index_add_``."""
    x = x.float()
    rr, rc = (h.rem_cols, h.rem_rows) if transpose else (h.rem_rows,
                                                        h.rem_cols)
    return spmm_reference(h.tiles, x, transpose).index_add_(
        0, rr, h.rem_vals[:, None] * x[rc])
