"""Pure-Python HDF5 reader (the NETCDF4 subset), no libhdf5.

Reads the HDF5 files that the reference stack writes cutouts as (xarray
``to_netcdf`` with the netcdf4/h5netcdf engines — reference
cutout.py:151-154): superblock v0/v2/v3, v1 and v2 object headers with
continuation blocks, old-style (symbol-table) and new-style (link message)
groups, contiguous / chunked (v1 b-tree) / compact dataset layouts,
deflate + shuffle + fletcher32 filters, compact attributes (incl. vlen
object-reference DIMENSION_LIST via the global heap), and the netCDF-4
dimension-scale convention for recovering named dimensions.

Structures follow the HDF5 File Format Specification v3.0 (public,
support.hdfgroup.org).  Validated against h5py-written files in
tests/test_netcdf.py.

A copy of ``atlite_tpu/io/hdf5.py`` (the port imports nothing of the JAX
package), but for the version-2 filter pipeline, which ``_parse_filters``
reads as libhdf5 writes it: the JAX package refuses such a file's
shuffle + deflate datasets (``tests/test_torch_netcdf.py`` holds the port
against h5py there).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIG = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF


class _F:
    """File wrapper with the whole buffer in memory (cutout-scale files)."""

    def __init__(self, path):
        if isinstance(path, (bytes, bytearray)):
            self.buf = bytes(path)
        else:
            with open(path, "rb") as fh:
                self.buf = fh.read()

    def u(self, off, n):
        return int.from_bytes(self.buf[off:off + n], "little")

    def b(self, off, n):
        return self.buf[off:off + n]


# ------------------------------------------------------------- datatypes
class Datatype:
    def __init__(self, cls, size, bitfield, props, base=None, members=None):
        self.cls = cls
        self.size = size
        self.bitfield = bitfield
        self.props = props
        self.base = base          # vlen/array base type
        self.members = members    # compound

    @property
    def numpy_dtype(self):
        bo = ">" if (self.bitfield & 1) else "<"
        if self.cls == 0:  # fixed-point
            signed = "i" if (self.bitfield & 0x08) else "u"
            return np.dtype(f"{bo}{signed}{self.size}")
        if self.cls == 1:  # float
            return np.dtype(f"{bo}f{self.size}")
        if self.cls == 3:  # string (fixed length)
            return np.dtype(f"S{self.size}")
        if self.cls == 7:  # reference (object address)
            return np.dtype("<u8")
        raise NotImplementedError(f"datatype class {self.cls}")


def _parse_datatype(buf, off):
    b0 = buf[off]
    version, cls = b0 >> 4, b0 & 0x0F
    bitfield = int.from_bytes(buf[off + 1:off + 4], "little")
    size = int.from_bytes(buf[off + 4:off + 8], "little")
    pos = off + 8
    base = members = None
    if cls == 0 or cls == 1:   # fixed/float properties
        pos += 4 if cls == 0 else 12
    elif cls == 4:             # bitfield: offset(2) precision(2)
        pos += 4
    elif cls == 3:             # string: no properties
        pass
    elif cls == 7:             # reference
        pass
    elif cls == 9:             # vlen: base type follows
        base, pos = _parse_datatype(buf, pos)
    elif cls == 6:             # compound
        members = []
        n = bitfield & 0xFFFF
        for _ in range(n):
            if version == 1:
                end = buf.index(b"\x00", pos)
                name = buf[pos:end].decode()
                pos += ((end - pos) // 8 + 1) * 8
                boff = int.from_bytes(buf[pos:pos + 4], "little")
                # byte offset(4) dimensionality(1) reserved(3)
                # permutation(4) reserved(4) dim sizes(4x4)
                pos += 4 + 1 + 3 + 4 + 4 + 16
                mt, pos = _parse_datatype(buf, pos)
            elif version == 2:
                end = buf.index(b"\x00", pos)
                name = buf[pos:end].decode()
                pos += ((end - pos) // 8 + 1) * 8
                boff = int.from_bytes(buf[pos:pos + 4], "little")
                pos += 4
                mt, pos = _parse_datatype(buf, pos)
            else:  # version 3: name not padded, offset is minimal bytes
                end = buf.index(b"\x00", pos)
                name = buf[pos:end].decode()
                pos = end + 1
                nb = max(1, (size.bit_length() + 7) // 8)
                boff = int.from_bytes(buf[pos:pos + nb], "little")
                pos += nb
                mt, pos = _parse_datatype(buf, pos)
            members.append((name, boff, mt))
    elif cls == 10:            # array: dims then base
        if version < 3:
            nd = buf[pos]; pos += 4
            dims = [int.from_bytes(buf[pos + 4 * i:pos + 4 * i + 4], "little")
                    for i in range(nd)]
            pos += 4 * nd + 4 * nd  # dims + permutation (v2 has perm)
        else:
            nd = buf[pos]; pos += 1
            dims = [int.from_bytes(buf[pos + 4 * i:pos + 4 * i + 4], "little")
                    for i in range(nd)]
            pos += 4 * nd
        base, pos = _parse_datatype(buf, pos)
        base = Datatype(10, size, bitfield, {"dims": dims}, base=base)
        return base, pos
    else:
        raise NotImplementedError(f"datatype class {cls} v{version}")
    return Datatype(cls, size, bitfield, {}, base=base, members=members), pos


def _parse_dataspace(buf, off):
    version = buf[off]
    if version == 1:
        nd, flags = buf[off + 1], buf[off + 2]
        pos = off + 8
    elif version == 2:
        nd, flags = buf[off + 1], buf[off + 2]
        pos = off + 4
    else:
        raise NotImplementedError(f"dataspace version {version}")
    dims = [int.from_bytes(buf[pos + 8 * i:pos + 8 * i + 8], "little")
            for i in range(nd)]
    return tuple(dims)


# --------------------------------------------------------------- messages
def _iter_messages_v1(f, addr, nmsgs_total, header_size):
    """Yield (type, flags, body_offset, body_size) from a v1 object header."""
    # v1 prefix: version(1) res(1) nmsgs(2) refcount(4) headersize(4),
    # then messages begin after 4 bytes of alignment padding
    blocks = [(addr + 16, header_size)]
    count = 0
    while blocks and count < nmsgs_total:
        pos, remaining = blocks.pop(0)
        while remaining >= 8 and count < nmsgs_total:
            mtype = f.u(pos, 2)
            msize = f.u(pos + 2, 2)
            body = pos + 8
            if mtype == 0x0010:  # continuation
                blocks.append((f.u(body, 8), f.u(body + 8, 8)))
            else:
                yield mtype, f.buf[pos + 4], body, msize
            count += 1
            pos = body + msize
            remaining -= 8 + msize


def _iter_messages_v2(f, addr):
    assert f.b(addr, 4) == b"OHDR"
    flags = f.buf[addr + 5]
    pos = addr + 6
    if flags & 0x20:
        pos += 16
    if flags & 0x10:
        pos += 4
    size_bytes = 1 << (flags & 0x3)
    chunk0 = f.u(pos, size_bytes)
    pos += size_bytes
    co = 2 if (flags & 0x04) else 0
    blocks = [(pos, chunk0, False)]
    visited = 0
    while blocks:
        visited += 1
        if visited > 10_000:  # corrupt continuation cycle must not hang
            raise ValueError("object-header continuation cycle")
        pos, size, is_cont = blocks.pop(0)
        end = pos + size
        if is_cont:
            assert f.b(pos, 4) == b"OCHK"
            pos += 4
        while pos + 4 + co <= end - 4:  # leave room for gap/checksum
            mtype = f.buf[pos]
            msize = f.u(pos + 1, 2)
            mflags = f.buf[pos + 3]
            body = pos + 4 + co
            if mtype == 0x10:
                blocks.append((f.u(body, 8), f.u(body + 8, 8), True))
            else:
                yield mtype, mflags, body, msize
            pos = body + msize


def _object_messages(f, addr):
    if f.b(addr, 4) == b"OHDR":
        yield from _iter_messages_v2(f, addr)
    else:
        version = f.buf[addr]
        assert version == 1, f"object header version {version}"
        nmsgs = f.u(addr + 2, 2)
        header_size = f.u(addr + 8, 4)
        yield from _iter_messages_v1(f, addr, nmsgs, header_size)


# ------------------------------------------------------------- attributes
def _parse_attribute(f, off):
    buf = f.buf
    version = buf[off]
    name_size = f.u(off + 2, 2)
    dt_size = f.u(off + 4, 2)
    ds_size = f.u(off + 6, 2)
    if version == 1:
        pos = off + 8
        pad = lambda n: ((n + 7) // 8) * 8
        name = buf[pos:pos + name_size].split(b"\x00")[0].decode()
        pos += pad(name_size)
        dt, _ = _parse_datatype(buf, pos)
        pos += pad(dt_size)
        shape = _parse_dataspace(buf, pos)
        pos += pad(ds_size)
    elif version in (2, 3):
        pos = off + 8 + (1 if version == 3 else 0)
        name = buf[pos:pos + name_size].split(b"\x00")[0].decode()
        pos += name_size
        dt, _ = _parse_datatype(buf, pos)
        pos += dt_size
        shape = _parse_dataspace(buf, pos)
        pos += ds_size
    else:
        raise NotImplementedError(f"attribute version {version}")
    value = _read_attr_value(f, dt, shape, pos)
    return name, value


def _read_attr_value(f, dt, shape, pos):
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if dt.cls == 9:  # vlen
        out = []
        for i in range(n):
            off = pos + 16 * i
            length = f.u(off, 4)
            gaddr = f.u(off + 4, 8)
            gidx = f.u(off + 12, 4)
            data = _global_heap_object(f, gaddr, gidx)
            if dt.base.cls == 3 or (dt.bitfield & 0x0F) == 1:  # vlen string
                out.append(data.decode("utf-8", errors="replace"))
            else:
                base_dt = dt.base.numpy_dtype
                out.append(np.frombuffer(data, dtype=base_dt, count=length))
        return out if len(out) > 1 or shape else out[0]
    if dt.cls == 3:
        raw = f.b(pos, dt.size * n)
        if n == 1:
            return raw.split(b"\x00")[0].decode("utf-8", errors="replace")
        return [raw[i * dt.size:(i + 1) * dt.size].split(b"\x00")[0].decode()
                for i in range(n)]
    if dt.cls == 6:  # compound (REFERENCE_LIST) — return raw field dict list
        out = []
        for i in range(n):
            base = pos + dt.size * i
            rec = {}
            for mname, moff, mdt in dt.members:
                rec[mname] = np.frombuffer(
                    f.b(base + moff, mdt.size), dtype=mdt.numpy_dtype)[0]
            out.append(rec)
        return out
    arr = np.frombuffer(f.b(pos, dt.numpy_dtype.itemsize * n),
                        dtype=dt.numpy_dtype, count=n)
    arr = arr.astype(arr.dtype.newbyteorder("="))
    if shape:
        arr = arr.reshape(shape)
        return arr
    return arr[0].item() if arr.size == 1 else arr


def _global_heap_object(f, gaddr, gidx):
    assert f.b(gaddr, 4) == b"GCOL", "bad global heap collection"
    size = f.u(gaddr + 8, 8)
    pos = gaddr + 16
    end = gaddr + size
    while pos < end:
        idx = f.u(pos, 2)
        osize = f.u(pos + 8, 8)
        if idx == gidx:
            return f.b(pos + 16, osize)
        if idx == 0:
            break
        pos += 16 + ((osize + 7) // 8) * 8
    raise KeyError(f"global heap object {gidx} not found")


# ----------------------------------------------------------------- groups
def _local_heap(f, addr):
    assert f.b(addr, 4) == b"HEAP"
    data_addr = f.u(addr + 24, 8)
    return data_addr


def _heap_name(f, heap_data, offset):
    buf = f.buf
    end = buf.index(b"\x00", heap_data + offset)
    return buf[heap_data + offset:end].decode()


def _walk_group_btree(f, btree_addr, heap_data, out):
    assert f.b(btree_addr, 4) == b"TREE"
    level = f.buf[btree_addr + 5]
    n = f.u(btree_addr + 6, 2)
    pos = btree_addr + 8 + 16  # skip siblings
    pos += 8  # key 0
    for _ in range(n):
        child = f.u(pos, 8)
        pos += 8 + 8  # child + next key
        if level > 0:
            _walk_group_btree(f, child, heap_data, out)
        else:
            _read_snod(f, child, heap_data, out)


def _read_snod(f, addr, heap_data, out):
    assert f.b(addr, 4) == b"SNOD"
    n = f.u(addr + 6, 2)
    pos = addr + 8
    for _ in range(n):
        name_off = f.u(pos, 8)
        ohdr = f.u(pos + 8, 8)
        out.append((_heap_name(f, heap_data, name_off), ohdr))
        pos += 40


def _group_children(f, addr):
    """List (name, object_header_address) for a group (old or new style)."""
    children = []
    for mtype, mflags, body, msize in _object_messages(f, addr):
        if mtype == 0x0011:  # symbol table
            btree = f.u(body, 8)
            heap = f.u(body + 8, 8)
            heap_data = _local_heap(f, heap)
            _walk_group_btree(f, btree, heap_data, children)
        elif mtype == 0x0006:  # link message (new-style compact group)
            version = f.buf[body]
            flags = f.buf[body + 1]
            pos = body + 2
            if flags & 0x08:
                pos += 1  # link type
            if flags & 0x04:
                pos += 8  # creation order
            if flags & 0x10:
                pos += 1  # charset
            len_bytes = 1 << (flags & 0x3)
            nlen = f.u(pos, len_bytes)
            pos += len_bytes
            name = f.b(pos, nlen).decode()
            pos += nlen
            children.append((name, f.u(pos, 8)))  # hard link: header addr
    return children


# ---------------------------------------------------------------- datasets
_FILTER_DEFLATE, _FILTER_SHUFFLE, _FILTER_FLETCHER, _FILTER_SZIP = 1, 2, 3, 4
_FILTER_ZSTD = 32015  # registered HDF5 community filter (new-CDS NetCDF4)


def _check_alloc(shape, dtype, file_size):
    """Refuse implausible allocations before np.zeros touches them: a
    corrupt dataspace/chunk-dims field must raise, not OOM the host.
    The bound is absolute-with-ratio-slack, NOT a pure compression-ratio
    test — deflate/zstd exceed 1000:1 on uniform data (land-sea masks,
    constant layers), so small valid files can legitimately hold much
    larger datasets; what must be stopped is the astronomic corrupt-dims
    alloc."""
    n = float(np.prod(shape, dtype=np.float64)) if shape else 1.0
    nbytes = n * dtype.itemsize
    if nbytes > max(200.0 * max(file_size, 1), 8e9):
        raise ValueError(
            f"implausible dataset shape {tuple(shape)} ({nbytes:.3g} bytes "
            f"in a {file_size}-byte file)")


def _parse_filters(f, body):
    """[(filter id, client data)] of a filter pipeline message.  Version 1
    describes each filter in 8 bytes (id, name length, flags, client data
    count) with the name padded to 8; version 2 omits the name length (and
    name) for the library's own ids below 256, leaving 6 bytes, and pads
    nothing.  (The JAX package reads version 2 with version 1's offsets,
    so a libhdf5 ``libver="latest"`` file with shuffle before deflate
    fails there on a misread id.)"""
    buf = f.buf
    version = buf[body]
    nfilters = buf[body + 1]
    pos = body + (8 if version == 1 else 2)
    filters = []
    for _ in range(nfilters):
        fid = f.u(pos, 2)
        if version == 1:
            namelen, ncv = f.u(pos + 2, 2), f.u(pos + 6, 2)
            pos += 8 + ((namelen + 7) // 8) * 8
        else:
            namelen = f.u(pos + 2, 2) if fid >= 256 else 0
            pos += 4 if fid >= 256 else 2
            ncv = f.u(pos + 2, 2)
            pos += 4 + namelen
        cvals = [f.u(pos + 4 * i, 4) for i in range(ncv)]
        pos += 4 * ncv
        if version == 1 and ncv % 2 == 1:
            pos += 4
        filters.append((fid, cvals))
    return filters


def _walk_chunk_btree(f, addr, ndims, out):
    """ndims here is the KEY dimensionality = dataset rank + 1 (the stored
    keys carry one extra element-size dimension whose offset is 0)."""
    assert f.b(addr, 4) == b"TREE", "bad chunk b-tree node"
    level = f.buf[addr + 5]
    n = f.u(addr + 6, 2)
    key_size = 8 + ndims * 8
    pos = addr + 24
    for _ in range(n):
        chunk_size = f.u(pos, 4)
        filter_mask = f.u(pos + 4, 4)
        offsets = [f.u(pos + 8 + 8 * i, 8) for i in range(ndims)]
        child = f.u(pos + key_size, 8)
        if level > 0:
            _walk_chunk_btree(f, child, ndims, out)
        else:
            out.append((tuple(offsets), child, chunk_size, filter_mask))
        pos += key_size + 8


def _read_dataset(f, addr):
    """Read one dataset: returns (array, attrs dict)."""
    shape = ()
    dt = None
    layout = None
    filters = []
    attrs = {}
    for mtype, mflags, body, msize in _object_messages(f, addr):
        if mtype == 0x0001:
            shape = _parse_dataspace(f.buf, body)
        elif mtype == 0x0003:
            dt, _ = _parse_datatype(f.buf, body)
        elif mtype == 0x0008:
            layout = (body, msize)
        elif mtype == 0x000B:
            filters = _parse_filters(f, body)
        elif mtype == 0x000C:
            name, value = _parse_attribute(f, body)
            attrs[name] = value
    if dt is None or layout is None:
        raise ValueError("dataset missing datatype/layout")
    dtype = dt.numpy_dtype
    _check_alloc(shape, dtype, len(f.buf))
    body, msize = layout
    version = f.buf[body]
    if version == 4:
        return _read_dataset_layout_v4(f, body, shape, dtype, filters), attrs, shape
    if version != 3:
        raise NotImplementedError(f"data layout message v{version}")
    lclass = f.buf[body + 1]
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if lclass == 0:  # compact
        size = f.u(body + 2, 2)
        raw = f.b(body + 4, size)
        arr = np.frombuffer(raw, dtype=dtype, count=n).reshape(shape)
    elif lclass == 1:  # contiguous
        data_addr = f.u(body + 2, 8)
        if data_addr == UNDEF:
            arr = np.zeros(shape, dtype=dtype)
        else:
            arr = np.frombuffer(f.buf, dtype=dtype, count=n,
                                offset=data_addr).reshape(shape)
    elif lclass == 2:  # chunked
        ndims = f.buf[body + 2] - 1  # stored dimensionality includes elem dim
        btree = f.u(body + 3, 8)
        chunk_dims = [f.u(body + 11 + 4 * i, 4) for i in range(ndims)]
        arr = np.zeros(shape, dtype=dtype)
        if btree != UNDEF:
            chunks = []
            _walk_chunk_btree(f, btree, ndims + 1, chunks)
            chunks = [(offs[:ndims], caddr, csize, fmask)
                      for offs, caddr, csize, fmask in chunks]
            arr = _paste_chunks(f, chunks, chunk_dims, shape, dtype, filters)
    else:
        raise NotImplementedError(f"layout class {lclass}")
    arr = np.ascontiguousarray(arr).astype(dtype.newbyteorder("="), copy=False)
    return arr, attrs, shape


def _decode_chunk(raw, filters, dtype, fmask=0, max_out=None):
    # fmask bit i set = filter i was SKIPPED for this chunk (written when
    # a filter declines/fails on one chunk); applying it anyway would
    # zlib-error or silently scramble the block
    filters = [fc for i, fc in enumerate(filters) if not (fmask >> i) & 1]
    for fid, cvals in reversed(filters):
        if fid == _FILTER_DEFLATE:
            if max_out is not None:
                # bounded inflate: a corrupt chunk must not become a
                # decompression bomb (the expected size is known from the
                # chunk dims)
                d = zlib.decompressobj()
                out = d.decompress(raw, max_out + 1)
                if len(out) > max_out or (d.unconsumed_tail
                                          and len(out) == max_out + 1):
                    raise ValueError("chunk inflates past its nominal size")
                raw = out
            else:
                raw = zlib.decompress(raw)
        elif fid == _FILTER_SHUFFLE:
            raw = _unshuffle(raw, cvals[0] if cvals else dtype.itemsize)
        elif fid == _FILTER_FLETCHER:
            raw = raw[:-4]
        elif fid == _FILTER_ZSTD:
            from atlite_tpu_torch.io import zstd

            raw = zstd.decompress(raw, max_out if max_out is not None
                                  else 64 * len(raw) + (1 << 20))
        elif fid == _FILTER_SZIP:
            from atlite_tpu_torch.io import szip

            raw = szip.decompress(raw, cvals,
                                  max_out if max_out is not None
                                  else 64 * len(raw) + (1 << 20))
        else:
            raise NotImplementedError(
                f"HDF5 filter id {fid} not supported (have: deflate, "
                "shuffle, fletcher32, szip, zstd)")
    return raw


def _paste_chunks(f, chunks, chunk_dims, shape, dtype, filters):
    _check_alloc(shape, dtype, len(f.buf))
    _check_alloc(chunk_dims, dtype, len(f.buf))
    nominal = int(np.prod(chunk_dims, dtype=np.int64)) * dtype.itemsize
    arr = np.zeros(shape, dtype=dtype)
    for offsets, caddr, csize, fmask in chunks:
        raw = _decode_chunk(f.b(caddr, csize), filters, dtype, fmask,
                            max_out=nominal)
        block = np.frombuffer(raw, dtype=dtype).reshape(chunk_dims)
        sel = tuple(slice(o, min(o + c, s))
                    for o, c, s in zip(offsets, chunk_dims, shape))
        trim = tuple(slice(0, sl.stop - sl.start) for sl in sel)
        arr[sel] = block[trim]
    return arr


def _read_dataset_layout_v4(f, body, shape, dtype, filters):
    """Data layout message version 4 (written with libver='latest'):
    chunked datasets indexed by single-chunk / implicit / fixed-array."""
    lclass = f.buf[body + 1]
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if lclass == 0:
        size = f.u(body + 2, 2)
        return np.frombuffer(f.b(body + 4, size), dtype=dtype,
                             count=n).reshape(shape)
    if lclass == 1:
        addr = f.u(body + 2, 8)
        if addr == UNDEF:
            return np.zeros(shape, dtype=dtype)
        return np.frombuffer(f.buf, dtype=dtype, count=n,
                             offset=addr).reshape(shape)
    if lclass != 2:
        raise NotImplementedError(f"v4 layout class {lclass}")
    flags = f.buf[body + 2]
    nd = f.buf[body + 3]          # rank + 1 (element-size dim)
    enc = f.buf[body + 4]
    pos = body + 5
    dims = [f.u(pos + enc * i, enc) for i in range(nd)]
    pos += enc * nd
    itype = f.buf[pos]
    pos += 1
    chunk_dims = dims[:-1]
    rank = len(chunk_dims)
    grid = [max(1, -(-s // c)) for s, c in zip(shape, chunk_dims)]
    raw_chunk = int(np.prod(chunk_dims, dtype=np.int64)) * dtype.itemsize
    filtered = bool(flags & 0x02) or bool(filters)

    chunks = []
    if itype == 1:  # single chunk
        csize, fmask = raw_chunk, 0
        if flags & 0x02:
            csize = f.u(pos, 8)
            fmask = f.u(pos + 8, 4)
            pos += 12
        addr = f.u(pos, 8)
        if addr != UNDEF:
            chunks.append(((0,) * rank, addr, csize, fmask))
    elif itype == 2:  # implicit: contiguous unfiltered chunks, row-major
        addr = f.u(pos, 8)
        if addr != UNDEF:
            for li in range(int(np.prod(grid, dtype=np.int64))):
                offs = np.unravel_index(li, grid)
                chunks.append((
                    tuple(int(o) * c for o, c in zip(offs, chunk_dims)),
                    addr + li * raw_chunk, raw_chunk, 0,
                ))
    elif itype == 3:  # fixed array
        pos += 1  # page bits
        addr = f.u(pos, 8)
        if addr != UNDEF:
            assert f.b(addr, 4) == b"FAHD", "bad fixed-array header"
            client = f.buf[addr + 5]
            entry_size = f.buf[addr + 6]
            nentries = f.u(addr + 8, 8)
            dblock = f.u(addr + 16, 8)
            assert f.b(dblock, 4) == b"FADB", "bad fixed-array data block"
            epos = dblock + 4 + 1 + 1 + 8  # sig, version, client, hdr addr
            page_bits = f.buf[addr + 7]
            if nentries > (1 << page_bits):
                raise NotImplementedError("paged fixed-array chunk index")
            for li in range(nentries):
                e = epos + li * entry_size
                caddr = f.u(e, 8)
                if caddr == UNDEF or caddr == 0:
                    continue
                if client == 1:  # filtered: addr + size + mask
                    size_len = entry_size - 8 - 4
                    csize = f.u(e + 8, size_len)
                    fmask = f.u(e + 8 + size_len, 4)
                else:
                    csize, fmask = raw_chunk, 0
                offs = np.unravel_index(li, grid)
                chunks.append((
                    tuple(int(o) * c for o, c in zip(offs, chunk_dims)),
                    caddr, csize, fmask,
                ))
    else:
        raise NotImplementedError(f"v4 chunk index type {itype}")
    return _paste_chunks(f, chunks, chunk_dims, shape, dtype, filters)


def _unshuffle(raw, itemsize):
    if itemsize <= 1:
        return raw
    a = np.frombuffer(raw, dtype=np.uint8)
    n = len(raw) // itemsize
    tail = raw[n * itemsize:]
    out = a[: n * itemsize].reshape(itemsize, n).T.tobytes()
    return out + tail


# ------------------------------------------------------------- front door
def _root_address(f):
    assert f.b(0, 8) == SIG, "not an HDF5 file"
    version = f.buf[8]
    if version in (0, 1):
        so = f.buf[13]
        sl = f.buf[14]
        assert so == 8 and sl == 8, "only 8-byte offsets/lengths supported"
        pos = 24 if version == 0 else 28
        pos += 4 * 8  # base, free space, EOF, driver info
        # root group symbol table entry: link name offset(8) + header addr
        return f.u(pos + 8, 8)
    if version in (2, 3):
        return f.u(12 + 3 * 8, 8)
    raise NotImplementedError(f"superblock version {version}")


_INTERNAL_EXC = (IndexError, KeyError, TypeError, AssertionError, OverflowError,
                 MemoryError, UnicodeDecodeError, RecursionError,
                 struct.error, zlib.error)


def read(path):
    """Read an HDF5 file's root group.

    Returns (datasets, root_attrs): datasets maps name -> (array, attrs,
    shape).  Sub-groups are flattened with '/'-joined names.

    Malformed input fails as a clean ValueError/NotImplementedError (the
    codec trust boundary), never as a stray internal exception or hang.
    """
    try:
        return _read(path)
    except (ValueError, NotImplementedError):
        raise
    except _INTERNAL_EXC as exc:
        raise ValueError(f"corrupt HDF5 file: {exc!r}") from exc


def _read(path):
    f = _F(path)
    root = _root_address(f)
    datasets = {}
    root_attrs = {}
    for mtype, mflags, body, msize in _object_messages(f, root):
        if mtype == 0x000C:
            name, value = _parse_attribute(f, body)
            root_attrs[name] = value

    def visit(addr, prefix):
        for name, child in _group_children(f, addr):
            msgs = list(_object_messages(f, child))
            types = {t for t, _, _, _ in msgs}
            full = prefix + name
            if 0x0011 in types or (0x0002 in types and 0x0003 not in types) \
                    or (0x000A in types and 0x0003 not in types):
                visit(child, full + "/")
            else:
                datasets[full] = (child, msgs)

    visit(root, "")
    out = {}
    for name, (addr, _msgs) in datasets.items():
        try:
            out[name] = _read_dataset(f, addr)
        except NotImplementedError as exc:
            # name the dataset: "file uses filter X on dataset Y" beats a
            # bare filter id when triaging a foreign CDS download
            raise NotImplementedError(f"dataset {name!r}: {exc}") from exc
    return out, root_attrs, f


def read_netcdf4(path):
    """Read a NETCDF4-model HDF5 file into (dims, variables, attrs) with
    the same structure as netcdf3.read.

    Dimensions come from the netCDF-4 dimension-scale convention: datasets
    with CLASS='DIMENSION_SCALE' name the dims; data variables link to
    them through DIMENSION_LIST (vlen object references resolved through
    the global heap).  Falls back to shape matching when DIMENSION_LIST is
    absent."""
    try:
        return _read_netcdf4(path)
    except (ValueError, NotImplementedError):
        raise
    except _INTERNAL_EXC as exc:
        raise ValueError(f"corrupt NETCDF4 file: {exc!r}") from exc


def _read_netcdf4(path):
    raw, root_attrs, f = read(path)

    # map object-header address -> dataset name for reference resolution
    # (reuse the buffer read() already holds — a second _F would re-read
    # and double-buffer the whole file)
    addr_of = {}
    fobj = f
    root = _root_address(fobj)

    def visit(addr, prefix):
        for name, child in _group_children(fobj, addr):
            addr_of[child] = prefix + name
            msgs = list(_object_messages(fobj, child))
            types = {t for t, _, _, _ in msgs}
            # recurse into BOTH group styles (same test as read()'s
            # visit): scales inside new-style link-message subgroups
            # must land in addr_of or DIMENSION_LIST refs dangle
            if 0x0011 in types or (0x0002 in types and 0x0003 not in types) \
                    or (0x000A in types and 0x0003 not in types):
                visit(child, prefix + name + "/")

    visit(root, "")

    dim_scales = {}   # name -> length
    variables = {}
    for name, (arr, attrs, shape) in raw.items():
        cls = attrs.get("CLASS")
        if cls == "DIMENSION_SCALE":
            # "This is a netCDF dimension but not a netCDF variable" scales
            # are pure dimensions; real coordinate variables keep data
            dim_scales[name] = shape[0] if shape else 0
    dims = dict(dim_scales)

    for name, (arr, attrs, shape) in raw.items():
        cls = attrs.get("CLASS")
        nm_attr = attrs.get("NAME")
        if cls == "DIMENSION_SCALE" and isinstance(nm_attr, str) \
                and nm_attr.startswith("This is a netCDF dimension"):
            continue  # phony dimension-only dataset
        dlist = attrs.get("DIMENSION_LIST")
        if dlist is not None:
            if not isinstance(dlist, list):
                dlist = [dlist]
            dnames = []
            for refs in dlist:
                refs = np.atleast_1d(refs)
                ref_addr = int(refs[0])
                dnames.append(addr_of.get(ref_addr, None))
            if all(d is not None for d in dnames):
                dnames = tuple(dnames)
            else:
                dnames = None
        elif cls == "DIMENSION_SCALE":
            dnames = (name,)
        else:
            dnames = None
        if dnames is None:
            # shape-match fallback; a square variable must not get the
            # SAME dim twice (each known dim is consumed at most once)
            used = set()
            out_names = []
            for i, s in enumerate(shape):
                dn = next((d for d, ln in dims.items()
                           if ln == s and d not in used), f"dim_{i}")
                used.add(dn)
                out_names.append(dn)
            dnames = tuple(out_names)
            for dn, s in zip(dnames, shape):
                dims.setdefault(dn, s)
        clean = {k: v for k, v in attrs.items()
                 if k not in ("CLASS", "NAME", "DIMENSION_LIST",
                              "REFERENCE_LIST", "_Netcdf4Dimid",
                              "_Netcdf4Coordinates", "_NCProperties")}
        variables[name] = (dnames, arr, clean)

    attrs = {k: v for k, v in root_attrs.items() if k != "_NCProperties"}
    return dims, variables, attrs
