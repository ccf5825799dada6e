"""Pure-Python LMDB reader and writer for the reference's feature files
(JAX package ``data/lmdb_io.py``).

The reference ships precomputed Faster-R-CNN features as LMDB environments
(reference sam/datasets/_image_features_reader.py:66-76 opens them with
py-lmdb): a pickled ``keys`` entry plus one pickled ``{features, boxes,
image_h, image_w, num_boxes}`` record per image-id key. Without py-lmdb's C
extension, this module reads the on-disk format itself (the LMDB layout as
mdb.c writes it):

* :class:`MiniLmdbReader`: read-only B+tree lookup over a ``data.mdb``
  memory map (meta page chosen by txnid, branch-page descent, leaf scan,
  overflow values). Every read is checked against the file: the descent is
  bounded by the tree depth in the meta record (so a cyclic tree ends),
  every page and overflow run must lie inside the file, every node inside
  its page, and a malformed file raises ``ValueError`` (never an
  ``assert``, which ``python -O`` removes).
* :func:`write_lmdb`: a valid single-snapshot LMDB environment from a
  ``{key: value}`` mapping (sorted leaf pages, branch levels, overflow
  pages for big values, twin meta pages), which py-lmdb opens;
  :func:`write_reference_feature_lmdb` writes features in the reference's
  layout with it.

Only what feature files use is implemented: the main database, memcmp key
order, no dupsort, subdatabases or LEAF2 pages.
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
from typing import Dict, Iterator, List, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1
PAGEHDRSZ = 16
PSIZE = 4096

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

P_INVALID = 0xFFFFFFFFFFFFFFFF

# header+key+data larger than this goes to overflow pages: mdb.c's
# me_nodemax for 4 KiB pages, ((psize - PAGEHDRSZ) / MDB_MINKEYS) & -2
NODEMAX = ((PSIZE - PAGEHDRSZ) // 2) & ~1
#: mdb.c's MDB_MAXKEYSIZE default
MAX_KEY = 511

_META = struct.Struct("<II Q Q")          # magic, version, address, mapsize
_DB = struct.Struct("<I H H Q Q Q Q Q")   # pad, flags, depth, branch, leaf,
                                          # overflow, entries, root
_TAIL = struct.Struct("<Q Q")             # last_pg, txnid
_PGHDR = struct.Struct("<Q H H H H")      # pgno, pad, flags, lower, upper
_OVHDR = struct.Struct("<Q H H I")        # pgno, pad, flags, n_pages
_NODE = struct.Struct("<H H H H")         # lo, hi, flags, ksize


def _even(n: int) -> int:
    return (n + 1) & ~1


def resolve_data_file(path: str) -> str:
    """An LMDB environment path is usually a directory holding data.mdb
    (py-lmdb's subdir=True default, how the reference's .lmdb dirs ship); a
    bare file is accepted too (subdir=False)."""
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


class MiniLmdbReader:
    """Read-only key lookup over an LMDB data file: ``get(key) -> bytes |
    None`` (the one call of py-lmdb the feature sources make) and
    ``items()``. Raises ``ValueError`` on a file that is not a well-formed
    LMDB environment."""

    def __init__(self, path: str):
        self.path = resolve_data_file(path)
        with open(self.path, "rb") as f:
            try:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except ValueError:  # zero-length file
                raise ValueError(f"not an LMDB data file: {self.path}") from None
        self._size = len(self._mm)
        self._root, self._psize, self._entries, self._depth = self._pick_meta()
        if self._root != P_INVALID and not 1 <= self._depth <= 64:
            raise ValueError(f"{self.path}: implausible tree depth {self._depth}")

    def _fail(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def _read_meta(self, pgno: int):
        off = pgno * PSIZE + PAGEHDRSZ
        if off + _META.size + 2 * _DB.size + _TAIL.size > self._size:
            return None
        magic, version, _addr, _mapsize = _META.unpack_from(self._mm, off)
        if magic != MDB_MAGIC or version != MDB_DATA_VERSION:
            return None
        free_db = _DB.unpack_from(self._mm, off + _META.size)
        main_db = _DB.unpack_from(self._mm, off + _META.size + _DB.size)
        _last_pg, txnid = _TAIL.unpack_from(self._mm, off + _META.size + 2 * _DB.size)
        psize = free_db[0] or PSIZE  # mm_psize lives in the free DB's md_pad
        # txnid, root, psize, entries, depth
        return txnid, main_db[7], psize, main_db[6], main_db[2]

    def _pick_meta(self):
        """Twin meta pages; the one with the larger txnid is live."""
        metas = [m for m in (self._read_meta(0), self._read_meta(1)) if m]
        if not metas:
            self._fail("not an LMDB data file (no valid meta page)")
        _txnid, root, psize, entries, depth = max(metas, key=lambda m: m[0])
        if psize < 512 or psize > 65536 or psize & (psize - 1):
            self._fail(f"implausible page size {psize}")
        return root, psize, entries, depth

    # ---- page parsing -----------------------------------------------------

    def _page(self, pgno: int) -> Tuple[int, memoryview]:
        off = pgno * self._psize
        if pgno < 2 or off + self._psize > self._size:
            self._fail(f"page {pgno} lies outside the file ({self._size} bytes)")
        page = memoryview(self._mm)[off: off + self._psize]
        _pg, _pad, flags, lower, upper = _PGHDR.unpack_from(page, 0)
        if not PAGEHDRSZ <= lower <= upper <= self._psize:
            self._fail(f"page {pgno} has a malformed header")
        n = (lower - PAGEHDRSZ) // 2
        ptrs = list(struct.unpack_from(f"<{n}H", page, PAGEHDRSZ)) if n else []
        for p in ptrs:
            if not upper <= p <= self._psize - _NODE.size:
                self._fail(f"page {pgno} has a node outside the page")
        return flags, page, ptrs

    def _node(self, page: memoryview, off: int):
        lo, hi, flags, ksize = _NODE.unpack_from(page, off)
        kstart = off + _NODE.size
        if kstart + ksize > self._psize:
            self._fail("a node's key runs past its page")
        return lo, hi, flags, bytes(page[kstart: kstart + ksize]), kstart + ksize

    def _leaf_value(self, page: memoryview, off: int) -> bytes:
        lo, hi, flags, _key, dstart = self._node(page, off)
        dsize = lo | (hi << 16)
        if flags & F_BIGDATA:
            if dstart + 8 > self._psize:
                self._fail("an overflow reference runs past its page")
            (ov_pgno,) = struct.unpack_from("<Q", page, dstart)
            return self._overflow(ov_pgno, dsize)
        if dstart + dsize > self._psize:
            self._fail("a value runs past its page")
        return bytes(page[dstart: dstart + dsize])

    def _overflow(self, pgno: int, size: int) -> bytes:
        off = pgno * self._psize
        if pgno < 2 or off + PAGEHDRSZ > self._size:
            self._fail(f"overflow page {pgno} lies outside the file")
        _pg, _pad, flags, n_pages = _OVHDR.unpack_from(self._mm, off)
        if not flags & P_OVERFLOW:
            self._fail(f"page {pgno} is not an overflow page")
        if PAGEHDRSZ + size > n_pages * self._psize:
            self._fail(f"a {size}-byte value does not fit its {n_pages} overflow pages")
        if off + n_pages * self._psize > self._size:
            self._fail(f"overflow pages {pgno}+{n_pages} run past the end of the file")
        start = off + PAGEHDRSZ
        return bytes(self._mm[start: start + size])

    @staticmethod
    def _child(lo: int, hi: int, flags: int) -> int:
        return lo | (hi << 16) | (flags << 32)  # a 48-bit page number

    # ---- B+tree descent ---------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        if self._root == P_INVALID:
            return None
        pgno = self._root
        # a tree of depth d has d - 1 branch levels above its leaves
        for _ in range(self._depth):
            flags, page, ptrs = self._page(pgno)
            if flags & P_LEAF:
                for off in ptrs:
                    if self._node(page, off)[3] == key:
                        return self._leaf_value(page, off)
                return None
            if not flags & P_BRANCH or not ptrs:
                self._fail(f"page {pgno} is neither a branch nor a leaf")
            # child 0 covers keys below key(node 1): descend to the rightmost
            # child whose separator key is <= the target
            idx = 0
            for i in range(1, len(ptrs)):
                if self._node(page, ptrs[i])[3] <= key:
                    idx = i
                else:
                    break
            lo, hi, nflags, _k, _end = self._node(page, ptrs[idx])
            pgno = self._child(lo, hi, nflags)
        self._fail(f"no leaf within the tree depth {self._depth} (a cyclic tree)")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order scan of every (key, value)."""
        if self._root == P_INVALID:
            return
        stack = [(self._root, 1)]
        while stack:
            pgno, level = stack.pop()
            if level > self._depth:
                self._fail(f"no leaf within the tree depth {self._depth} (a cyclic tree)")
            flags, page, ptrs = self._page(pgno)
            if flags & P_BRANCH:
                for off in reversed(ptrs):
                    lo, hi, nflags, _k, _end = self._node(page, off)
                    stack.append((self._child(lo, hi, nflags), level + 1))
            elif flags & P_LEAF:
                for off in ptrs:
                    yield self._node(page, off)[3], self._leaf_value(page, off)
            else:
                self._fail(f"page {pgno} is neither a branch nor a leaf")

    def close(self):
        self._mm.close()


# ---- writer ----------------------------------------------------------------


def _leaf_node(key: bytes, value: bytes, overflow_pgno: Optional[int]) -> bytes:
    if overflow_pgno is None:
        blob = _NODE.pack(len(value) & 0xFFFF, len(value) >> 16, 0, len(key))
        blob += key + value
    else:
        blob = _NODE.pack(len(value) & 0xFFFF, len(value) >> 16, F_BIGDATA, len(key))
        blob += key + struct.pack("<Q", overflow_pgno)
    return blob + b"\x00" * (_even(len(blob)) - len(blob))


def _branch_node(key: bytes, child_pgno: int) -> bytes:
    blob = _NODE.pack(child_pgno & 0xFFFF, (child_pgno >> 16) & 0xFFFF,
                      (child_pgno >> 32) & 0xFFFF, len(key))
    blob += key
    return blob + b"\x00" * (_even(len(blob)) - len(blob))


def _pack_page(pgno: int, flags: int, node_blobs: List[bytes]) -> bytes:
    page = bytearray(PSIZE)
    upper = PSIZE
    ptrs = []
    for blob in node_blobs:
        upper -= len(blob)
        page[upper: upper + len(blob)] = blob
        ptrs.append(upper)
    lower = PAGEHDRSZ + 2 * len(ptrs)
    if lower > upper:
        raise ValueError(f"page {pgno} overfull")
    _PGHDR.pack_into(page, 0, pgno, 0, flags, lower, upper)
    struct.pack_into(f"<{len(ptrs)}H", page, PAGEHDRSZ, *ptrs)
    return bytes(page)


def write_lmdb(path: str, items: Dict[bytes, bytes], subdir: bool = True) -> str:
    """Write ``items`` as a valid LMDB environment at ``path``: twin meta
    pages, sorted leaf pages, branch levels as needed, overflow pages for
    values whose node would exceed NODEMAX. Returns the data file's path."""
    if subdir:
        os.makedirs(path, exist_ok=True)
        data_path = os.path.join(path, "data.mdb")
    else:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        data_path = path

    entries = sorted(items.items())
    pages: Dict[int, bytes] = {}
    next_pgno = 2  # 0 and 1 are the metas

    # overflow pages first, so that leaf nodes can reference them
    node_blobs: List[Tuple[bytes, bytes]] = []  # (key, packed leaf node)
    n_overflow = 0
    for key, value in entries:
        if len(key) > MAX_KEY:
            raise ValueError(f"key too long for LMDB's default maxkeysize: {key!r}")
        if _NODE.size + len(key) + len(value) > NODEMAX:
            npages = (PAGEHDRSZ + len(value) + PSIZE - 1) // PSIZE
            chunk = bytearray(npages * PSIZE)
            _OVHDR.pack_into(chunk, 0, next_pgno, 0, P_OVERFLOW, npages)
            chunk[PAGEHDRSZ: PAGEHDRSZ + len(value)] = value
            for i in range(npages):
                pages[next_pgno + i] = bytes(chunk[i * PSIZE:(i + 1) * PSIZE])
            node_blobs.append((key, _leaf_node(key, value, next_pgno)))
            next_pgno += npages
            n_overflow += npages
        else:
            node_blobs.append((key, _leaf_node(key, value, None)))

    def fill_pages(blobs: List[Tuple[bytes, bytes]], flags: int, pgno0: int):
        """Greedy first-fit packing in sort order; returns (pages,
        first_keys, next_pgno)."""
        out, firsts = [], []
        cur: List[bytes] = []
        cur_size = PAGEHDRSZ
        pgno = pgno0
        for key, blob in blobs:
            if cur and cur_size + 2 + len(blob) > PSIZE:
                out.append(_pack_page(pgno, flags, cur))
                pgno += 1
                cur, cur_size = [], PAGEHDRSZ
            if not cur:
                firsts.append(key)
            cur.append(blob)
            cur_size += 2 + len(blob)
        if cur:
            out.append(_pack_page(pgno, flags, cur))
            pgno += 1
        return out, firsts, pgno

    leaf_pages, leaf_firsts, next_after = fill_pages(node_blobs, P_LEAF, next_pgno)
    for i, pg in enumerate(leaf_pages):
        pages[next_pgno + i] = pg
    level_pgnos = list(range(next_pgno, next_after))
    level_firsts = leaf_firsts
    next_pgno = next_after
    depth = 1
    n_branch = 0

    while len(level_pgnos) > 1:
        blobs = []
        for i, (key, child) in enumerate(zip(level_firsts, level_pgnos)):
            # node 0's separator key is never compared; mdb stores it empty
            blobs.append((key, _branch_node(b"" if i == 0 else key, child)))
        branch_pages, branch_firsts, next_after = fill_pages(blobs, P_BRANCH, next_pgno)
        for i, pg in enumerate(branch_pages):
            pages[next_pgno + i] = pg
        level_pgnos = list(range(next_pgno, next_after))
        level_firsts = branch_firsts
        n_branch += len(branch_pages)
        next_pgno = next_after
        depth += 1

    root = level_pgnos[0] if entries else P_INVALID
    last_pg = max(next_pgno - 1, 1)
    mapsize = max(10 * 1024 * 1024, (last_pg + 1) * PSIZE)

    def meta_page(pgno: int, txnid: int) -> bytes:
        page = bytearray(PSIZE)
        _PGHDR.pack_into(page, 0, pgno, 0, P_META, 0, 0)
        off = PAGEHDRSZ
        _META.pack_into(page, off, MDB_MAGIC, MDB_DATA_VERSION, 0, mapsize)
        off += _META.size
        # free DB: md_pad carries the page size (mm_psize); empty tree
        _DB.pack_into(page, off, PSIZE, 0, 0, 0, 0, 0, 0, P_INVALID)
        off += _DB.size
        _DB.pack_into(page, off, 0, 0, depth if entries else 0, n_branch,
                      len(leaf_pages), n_overflow, len(entries), root)
        off += _DB.size
        _TAIL.pack_into(page, off, last_pg, txnid)
        return bytes(page)

    with open(data_path, "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        for pgno in range(2, next_pgno):
            f.write(pages[pgno])
    return data_path


def write_reference_feature_lmdb(path: str, images: Dict[str, Dict]) -> str:
    """Write image features in the reference's layout (reference
    _image_features_reader.py:66-76): a pickled sorted ``keys`` list and one
    pickled ``{features, boxes, image_h, image_w, num_boxes}`` record per
    image id."""
    items: Dict[bytes, bytes] = {}
    keys = []
    for image_id, rec in images.items():
        k = str(image_id).encode()
        keys.append(k)
        items[k] = pickle.dumps({
            "features": rec["features"],
            "boxes": rec["boxes"],
            "image_h": int(rec["image_h"]),
            "image_w": int(rec["image_w"]),
            "num_boxes": int(rec["features"].shape[0]),
        })
    items[b"keys"] = pickle.dumps(sorted(keys))
    return write_lmdb(path, items)
