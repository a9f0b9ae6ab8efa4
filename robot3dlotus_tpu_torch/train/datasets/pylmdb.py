"""LMDB (Lightning Memory-Mapped Database) files in pure Python (the
port's copy of robot3dlotus_tpu/train/datasets/pylmdb.py).

GemBench stores episodes as one LMDB environment per taskvar with
msgpack values. This module reads and writes the on-disk format directly
(liblmdb's mdb.c, file format version 1, little-endian, 64-bit), so no
`lmdb` binding is needed:

  * page size 4096; pages 0 and 1 are meta pages (magic 0xBEEFC0DE); the
    live meta is the one with the larger txnid;
  * the main DB root is a B+tree of branch/leaf pages; node pointers are
    uint16 offsets growing from the header while node bodies grow down
    from the page end;
  * leaf nodes hold key+value inline, or (F_BIGDATA) an 8-byte pointer to
    a run of contiguous overflow pages;
  * branch nodes hold key + 48-bit child pgno split across mn_lo/mn_hi/
    mn_flags.

Reader (`LmdbFileReader`): read-only, mmap-backed, validating (a wrong
magic, version or flag raises rather than misparses). Safe for concurrent
reads from several threads: no mutable state after open.

Writer (`write_lmdb`): a fresh single-commit environment, the structure
liblmdb produces for "open, put N sorted items, commit", so the `lmdb`
binding opens what it writes and the reader opens the binding's files.
Its bytes equal the JAX package's writer's for the same items.
"""
from __future__ import annotations

import os
import mmap
import struct

PAGE_SIZE = 4096
PAGEHDRSZ = 16
NODESZ = 8
MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

# node flags
F_BIGDATA = 0x01

# MDB_db: md_pad u32, md_flags u16, md_depth u16, md_branch_pages u64,
# md_leaf_pages u64, md_overflow_pages u64, md_entries u64, md_root u64
_DB = struct.Struct("<IHHQQQQQ")
# MDB_meta: mm_magic u32, mm_version u32, mm_address u64, mm_mapsize u64,
# mm_dbs[2], mm_last_pg u64, mm_txnid u64
_META_HEAD = struct.Struct("<IIQQ")
_META_TAIL = struct.Struct("<QQ")
# page header: p_pgno u64, mp_pad u16, mp_flags u16, pb_lower u16, pb_upper u16
_PGHDR = struct.Struct("<QHHHH")
# node header: mn_lo u16, mn_hi u16, mn_flags u16, mn_ksize u16
_NODE = struct.Struct("<HHHH")


def _even(n):
    return n + (n & 1)


class LmdbFormatError(ValueError):
    pass


class LmdbFileReader:
    """Read-only view of one LMDB environment (main DB only, no dupsort).

    `path` may be the environment directory (containing data.mdb — the
    subdir=True layout) or the data file itself. lock.mdb is
    never touched, so a copied/readonly checkout works.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.page_size, self._db = self._pick_meta()
        self.entries = self._db[6]
        self._root = self._db[7]

    # -- format --

    def _meta_at(self, pgno, psize=PAGE_SIZE):
        off = pgno * psize  # meta 1 sits at the ENV's page size, not 4096
        pgno_, _, flags, _, _ = _PGHDR.unpack_from(self._mm, off)
        if not flags & P_META:
            raise LmdbFormatError(f"page {pgno}: not a meta page")
        body = off + PAGEHDRSZ
        magic, version, _, _ = _META_HEAD.unpack_from(self._mm, body)
        if magic != MDB_MAGIC:
            raise LmdbFormatError(f"bad magic {magic:#x}")
        if version != MDB_VERSION:
            raise LmdbFormatError(f"unsupported format version {version}")
        dbs_off = body + _META_HEAD.size
        free_db = _DB.unpack_from(self._mm, dbs_off)
        main_db = _DB.unpack_from(self._mm, dbs_off + _DB.size)
        last_pg, txnid = _META_TAIL.unpack_from(
            self._mm, dbs_off + 2 * _DB.size)
        # liblmdb stores the page size in the free DB's md_pad
        psize = free_db[0] or PAGE_SIZE
        return txnid, psize, main_db

    def _pick_meta(self):
        t0, p0, db0 = self._meta_at(0)
        # meta page 1 lives one ENV page in — discover the page size from
        # meta 0 first so non-default-psize environments parse (or fail
        # with a message naming the page size, not 'bad magic')
        try:
            t1, p1, db1 = self._meta_at(1, p0)
        except LmdbFormatError as e:
            raise LmdbFormatError(
                f"meta page 1 unreadable at page size {p0} "
                f"({e}) — corrupt or unsupported environment") from e
        return (p1, db1) if t1 > t0 else (p0, db0)

    def _page(self, pgno):
        off = pgno * self.page_size
        if off + PAGEHDRSZ > len(self._mm):
            raise LmdbFormatError(f"page {pgno} beyond file end")
        return _PGHDR.unpack_from(self._mm, off), off

    def _nodes(self, pgno):
        """Yield (key, node_flags, payload) for a branch/leaf page, where
        payload is the child pgno (branch) or the value bytes (leaf)."""
        (pg, _, flags, lower, upper), off = self._page(pgno)
        if pg != pgno:
            raise LmdbFormatError(f"page {pgno}: header pgno {pg}")
        nkeys = (lower - PAGEHDRSZ) >> 1
        for i in range(nkeys):
            (ptr,) = struct.unpack_from(
                "<H", self._mm, off + PAGEHDRSZ + 2 * i)
            noff = off + ptr
            lo, hi, nflags, ksize = _NODE.unpack_from(self._mm, noff)
            key = bytes(self._mm[noff + NODESZ:noff + NODESZ + ksize])
            if flags & P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                yield key, 0, child
            else:
                dsize = lo | (hi << 16)
                dstart = noff + NODESZ + ksize
                if nflags & F_BIGDATA:
                    (opg,) = struct.unpack_from("<Q", self._mm, dstart)
                    yield key, nflags, self._overflow(opg, dsize)
                else:
                    yield key, nflags, bytes(
                        self._mm[dstart:dstart + dsize])

    def _overflow(self, pgno, size):
        (pg, _, flags, lower, upper), off = self._page(pgno)
        if not flags & P_OVERFLOW:
            raise LmdbFormatError(f"page {pgno}: expected overflow page")
        npages = lower | (upper << 16)  # pb_pages u32 overlays lower/upper
        avail = npages * self.page_size - PAGEHDRSZ
        if size > avail:
            raise LmdbFormatError(
                f"overflow run at {pgno}: {size} > {avail}")
        start = off + PAGEHDRSZ
        return bytes(self._mm[start:start + size])

    # -- API --

    def items(self):
        """All (key, value) pairs in key order (in-order B+tree walk)."""
        if self._root == P_INVALID:
            return
        stack = [self._root]
        while stack:
            pgno = stack.pop()
            (_, _, flags, _, _), _ = self._page(pgno)
            if flags & P_LEAF:
                yield from ((k, v) for k, _, v in self._nodes(pgno))
            elif flags & P_BRANCH:
                # push children in reverse so the walk stays in key order
                stack.extend(reversed([c for _, _, c in self._nodes(pgno)]))
            else:
                raise LmdbFormatError(
                    f"page {pgno}: unexpected flags {flags:#x}")

    def keys(self):
        return (k for k, _ in self.items())

    def get(self, key: bytes):
        """Point lookup by B+tree descent."""
        if self._root == P_INVALID:
            return None
        pgno = self._root
        while True:
            (_, _, flags, _, _), _ = self._page(pgno)
            nodes = list(self._nodes(pgno))
            if flags & P_LEAF:
                for k, _, v in nodes:
                    if k == key:
                        return v
                return None
            # branch: rightmost child whose separator key <= target
            # (node 0's key is empty == -infinity)
            child = nodes[0][2]
            for k, _, c in nodes[1:]:
                if k <= key:
                    child = c
                else:
                    break
            pgno = child

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_lmdb(path: str, items, subdir: bool = True,
               page_size: int = PAGE_SIZE):
    """Write a fresh single-commit LMDB environment containing `items`
    (iterable of (key: bytes, value: bytes); keys de-duplicated last-wins
    and stored in memcmp order, matching liblmdb put semantics).

    Layout identical to liblmdb's after one write txn: metas on pages 0/1
    (live one on page 1, txnid 1), then leaves/overflow runs, then one
    branch root when the keys span multiple leaves (depth <= 2 — plenty
    for the per-taskvar episode counts this framework stores; loud error
    beyond that).
    """
    d = dict(items)
    pairs = sorted(d.items())
    for k, _ in pairs:
        if not 0 < len(k) <= 511:
            raise LmdbFormatError(f"key length {len(k)} unsupported")

    leaf_cap = page_size - PAGEHDRSZ       # bytes available for ptrs+nodes
    # nodes bigger than this spill the value to overflow pages (mdb.c
    # MDB_node max: page_size/2 minus headers; use liblmdb's nodemax)
    nodemax = (page_size - PAGEHDRSZ) // 2 - 2  # == mdb nodemax for psize

    pages = {}       # pgno -> bytes
    next_pg = [2]

    def alloc(n=1):
        pg = next_pg[0]
        next_pg[0] += n
        return pg

    def page_bytes(pgno, flags, ptrs_nodes, pb_pages=None):
        """Assemble one page: ptrs_nodes is [(offset, node_bytes)]."""
        buf = bytearray(page_size)
        if pb_pages is not None:
            _PGHDR.pack_into(buf, 0, pgno, 0, flags,
                             pb_pages & 0xFFFF, pb_pages >> 16)
        else:
            lower = PAGEHDRSZ + 2 * len(ptrs_nodes)
            upper = min((o for o, _ in ptrs_nodes), default=page_size)
            _PGHDR.pack_into(buf, 0, pgno, 0, flags, lower, upper)
            for i, (off, node) in enumerate(ptrs_nodes):
                struct.pack_into("<H", buf, PAGEHDRSZ + 2 * i, off)
                buf[off:off + len(node)] = node
        return bytes(buf)

    n_overflow = 0

    def leaf_node(key, val):
        """-> (node_bytes, consumed_size) writing overflow runs as needed."""
        nonlocal n_overflow
        inline = NODESZ + len(key) + len(val)
        if inline > nodemax:
            npgs = -(-(PAGEHDRSZ + len(val)) // page_size)
            opg = alloc(npgs)
            n_overflow += npgs
            raw = bytearray(npgs * page_size)
            raw[:page_size] = page_bytes(opg, P_OVERFLOW, [],
                                         pb_pages=npgs)
            raw[PAGEHDRSZ:PAGEHDRSZ + len(val)] = val
            for j in range(npgs):
                pages[opg + j] = bytes(
                    raw[j * page_size:(j + 1) * page_size])
            node = _NODE.pack(len(val) & 0xFFFF, len(val) >> 16,
                              F_BIGDATA, len(key)) + key + \
                struct.pack("<Q", opg)
        else:
            node = _NODE.pack(len(val) & 0xFFFF, len(val) >> 16,
                              0, len(key)) + key + val
        return node

    # pack leaves greedily in key order (liblmdb splits differently mid-tree
    # but any valid B+tree reads back identically through the binding)
    leaves = []      # (first_key, pgno)
    cur_nodes, cur_used = [], 0
    def flush_leaf():
        nonlocal cur_nodes, cur_used
        if not cur_nodes and leaves:
            return
        pg = alloc()
        off = page_size
        placed = []
        for key, node in cur_nodes:
            off -= _even(len(node))
            placed.append((off, node))
        pages[pg] = page_bytes(pg, P_LEAF, placed)
        leaves.append((cur_nodes[0][0] if cur_nodes else b"", pg))
        cur_nodes, cur_used = [], 0

    for key, val in pairs:
        node = leaf_node(key, val)
        need = 2 + _even(len(node))          # ptr slot + node body
        if cur_nodes and cur_used + need > leaf_cap:
            flush_leaf()
        cur_nodes.append((key, node))
        cur_used += need
    if cur_nodes:
        flush_leaf()

    if not leaves:  # empty DB: liblmdb keeps root = P_INVALID, depth 0
        root, depth, n_branch = P_INVALID, 0, 0
    elif len(leaves) == 1:
        root, depth, n_branch = leaves[0][1], 1, 0
    else:
        # one branch root; loud failure if even that overflows
        nodes = []
        used = 0
        for i, (first, pg) in enumerate(leaves):
            key = b"" if i == 0 else first
            node = _NODE.pack(pg & 0xFFFF, (pg >> 16) & 0xFFFF,
                              (pg >> 32) & 0xFFFF, len(key)) + key
            used += 2 + _even(len(node))
            nodes.append((key, node))
        if used > leaf_cap:
            raise LmdbFormatError(
                f"{len(leaves)} leaves need a deeper tree than this "
                "writer emits; shard the store or raise page_size")
        pg = alloc()
        off = page_size
        placed = []
        for key, node in nodes:
            off -= _even(len(node))
            placed.append((off, node))
        pages[pg] = page_bytes(pg, P_BRANCH, placed)
        root, depth, n_branch = pg, 2, 1

    last_pg = next_pg[0] - 1
    free_db = _DB.pack(page_size, 0, 0, 0, 0, 0, 0, P_INVALID)

    def meta(pgno, txnid, live):
        main = _DB.pack(0, 0, depth if live else 0, n_branch,
                        len(leaves) if live else 0, n_overflow,
                        len(pairs) if live else 0,
                        root if live else P_INVALID)
        body = _META_HEAD.pack(MDB_MAGIC, MDB_VERSION, 0,
                               max((last_pg + 1) * page_size, 1 << 20)) \
            + free_db + main + _META_TAIL.pack(last_pg, txnid)
        buf = bytearray(page_size)
        _PGHDR.pack_into(buf, 0, pgno, 0, P_META, 0, 0)
        buf[PAGEHDRSZ:PAGEHDRSZ + len(body)] = body
        return bytes(buf)

    if subdir:
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, "data.mdb")
    else:
        out = path
    with open(out, "wb") as f:
        f.write(meta(0, 0, live=False))
        f.write(meta(1, 1, live=True))
        for pg in range(2, last_pg + 1):
            f.write(pages[pg])
    return out
