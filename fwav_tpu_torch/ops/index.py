"""The candidate index: the torch counterpart of fwav_tpu/ops/index.py.

The reference builds an HNSW inner-product graph over the domain
embeddings; here the "index" is the embedding matrix itself, queried by
one exact blockwise top-k (ops/search.py topk_scores_block, recall 1.0).
The lifecycle (build, persist, load, query) is the JAX package's, and so is
the FWIX file: b'FWIX', then n and dim as two little-endian u32, then the
float32 rows. Embedding and queries run on `device`, "cuda" by default;
the results come back as numpy, as the JAX package's do.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..utils.buckets import bucket
from ..utils.device import resolve_device
from .search import topk_scores_block

_MAGIC = b"FWIX"


class MIPSIndex:
    """Exact maximum-inner-product 'index' over (n, emb_dim) embeddings."""

    def __init__(self, embeddings: np.ndarray):
        self.embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)

    @property
    def n(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    def save(self, path) -> None:
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<II", self.n, self.dim))
            f.write(self.embeddings.tobytes())

    @classmethod
    def load(cls, path) -> "MIPSIndex":
        with open(path, "rb") as f:
            if f.read(4) != _MAGIC:
                raise ValueError("Not a FWIX index file")
            n, dim = struct.unpack("<II", f.read(8))
            data = np.frombuffer(f.read(n * dim * 4), dtype=np.float32)
        return cls(data.reshape(n, dim))

    def query(self, queries, top_k: int = 32, domain_block: int = 2048, device="cuda"):
        """(M, E) queries -> (idx (M, k) int32 by descending score, scores
        (M, k)), numpy. Exact top-k by inner product on `device`; -1 fills
        when k > n."""
        dev = resolve_device(device)
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        db = bucket(max(self.n, 1), 256)
        emb = np.zeros((db, self.dim), np.float32)
        emb[: self.n] = self.embeddings
        valid = np.zeros(db, bool)
        valid[: self.n] = True
        blk = min(domain_block, db)
        while db % blk:
            blk //= 2
        scores, idx = topk_scores_block(
            torch.from_numpy(q).to(dev), torch.from_numpy(emb).to(dev),
            torch.from_numpy(valid).to(dev), top_k, blk,
        )
        return idx.cpu().numpy(), scores.cpu().numpy()


def build_domain_embeddings(domains_path, n_domains: int, range_size: int,
                            emb_dim: int = 16, block_size: int = 4096, tmpdir=None,
                            device="cuda"):
    """Reference-shaped embedding-store builder: memmap the (n_domains,
    range_size) float32 domain file, embed it block by block on `device`
    with the multi-head DCT embedding, write a float32 (n_domains, emb_dim)
    '.emb' memmap and return its path."""
    import tempfile

    from .dct import multi_head_embedding_batch

    dev = resolve_device(device)
    emb_file = tempfile.NamedTemporaryFile(delete=False, suffix=".emb", dir=tmpdir)
    emb_path = emb_file.name
    emb_file.close()

    domains_mm = np.memmap(
        domains_path, dtype="float32", mode="r", shape=(n_domains, range_size)
    )
    emb_mm = np.memmap(emb_path, dtype="float32", mode="w+", shape=(n_domains, emb_dim))
    for i in range(0, n_domains, block_size):
        blk = np.array(domains_mm[i : i + block_size])
        emb_mm[i : i + len(blk)] = multi_head_embedding_batch(
            torch.from_numpy(blk).to(dev), tonal_k=emb_dim // 2,
            transient_k=emb_dim - emb_dim // 2,
        ).cpu().numpy()
    emb_mm.flush()
    return emb_path


def build_ann_index(emb_path, n_domains, emb_dim=16, index_path=None,
                    method="mips", ef=None, M=None):
    """Reference-shaped builder: reads the float32 embedding file, saves
    the exact index next to it (emb_path + '.ann') and returns its path.
    `method`, `ef` and `M` are accepted for the reference's signature: an
    exact index has no graph parameters."""
    if index_path is None:
        index_path = str(emb_path) + ".ann"
    emb = np.memmap(emb_path, dtype="float32", mode="r", shape=(n_domains, emb_dim))
    MIPSIndex(np.asarray(emb)).save(index_path)
    return index_path


def ann_query(range_block, index_path, top_k: int = 32, emb_dim: int = 16, device="cuda"):
    """Reference-shaped standalone query on `device`: embeds the range
    with the embedding the index was built with and returns its candidate
    rows; an empty array on any failure of the index, as the reference
    does. A device that cannot be had raises instead."""
    from .dct import multi_head_embedding

    resolve_device(device)
    if index_path is None:
        return np.empty((0,), dtype=np.int32)
    try:
        index = MIPSIndex.load(index_path)
        q = multi_head_embedding(
            np.asarray(range_block, dtype=np.float32),
            tonal_k=index.dim // 2,
            transient_k=index.dim - index.dim // 2,
            device=device,
        )
        idx, _ = index.query(q[None, :], top_k=top_k, device=device)
        return idx[0][idx[0] >= 0].astype(np.int32)
    except Exception:  # noqa: BLE001 — the reference's contract: empty on failure
        return np.empty((0,), dtype=np.int32)
