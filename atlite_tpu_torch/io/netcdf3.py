"""NetCDF-3 (classic and 64-bit-offset) reader/writer, pure Python.

Implements the CDF-1/CDF-2 file format from the NetCDF classic format
specification so reference-stack cutouts round-trip without the netCDF4/
HDF5 C libraries (reference persists cutouts via xarray.to_netcdf,
atlite's data.py:254-270).  Validated against
scipy.io.netcdf_file in both directions (tests/test_netcdf.py).

Format summary (all big-endian):
    header  = magic('CDF' + \\x01|\\x02) numrecs dim_list gatt_list var_list
    lists   = tag(u32) count(u32) entries...   (absent list: 0 0)
    name    = len(u32) bytes padded to 4
    attr    = name nc_type(u32) nelems(u32) values-padded-4
    var     = name ndims(u32) dimids attr_list nc_type vsize(u32) begin
              (begin is u32 in CDF-1, u64 in CDF-2)
    data    = fixed vars at begin; record vars interleave per record.

A copy of ``atlite_tpu/io/netcdf3.py``: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import struct

import numpy as np

NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6
NC_DIMENSION, NC_VARIABLE, NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C

_DTYPES = {
    NC_BYTE: np.dtype(">i1"), NC_CHAR: np.dtype("S1"),
    NC_SHORT: np.dtype(">i2"), NC_INT: np.dtype(">i4"),
    NC_FLOAT: np.dtype(">f4"), NC_DOUBLE: np.dtype(">f8"),
}
_SIZES = {NC_BYTE: 1, NC_CHAR: 1, NC_SHORT: 2, NC_INT: 4, NC_FLOAT: 4,
          NC_DOUBLE: 8}
_FROM_KIND = {("i", 1): NC_BYTE, ("u", 1): NC_BYTE, ("S", 1): NC_CHAR,
              ("i", 2): NC_SHORT, ("i", 4): NC_INT, ("f", 4): NC_FLOAT,
              ("f", 8): NC_DOUBLE}


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def u32(self):
        v = struct.unpack_from(">I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def u64(self):
        v = struct.unpack_from(">Q", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def name(self):
        n = self.u32()
        s = self.buf[self.pos:self.pos + n].decode("utf-8")
        self.pos += (n + 3) & ~3
        return s

    def values(self, nc_type, nelems):
        nbytes = _SIZES[nc_type] * nelems
        raw = self.buf[self.pos:self.pos + nbytes]
        self.pos += (nbytes + 3) & ~3
        if nc_type == NC_CHAR:
            return raw.decode("utf-8", errors="replace")
        return np.frombuffer(raw, dtype=_DTYPES[nc_type]).astype(
            _DTYPES[nc_type].newbyteorder("="))

    def attrs(self):
        tag = self.u32()
        count = self.u32()
        assert tag in (NC_ATTRIBUTE, 0), f"bad attr tag {tag}"
        out = {}
        for _ in range(count):
            nm = self.name()
            t = self.u32()
            n = self.u32()
            vals = self.values(t, n)
            if not isinstance(vals, str) and vals.size == 1:
                vals = vals[0].item()
            out[nm] = vals
        return out


def read(path_or_bytes):
    """Parse a CDF-1/CDF-2 file.

    Returns (dims, variables, attrs): ``dims`` maps name->length (record
    dim resolved to its actual length), ``variables`` maps name ->
    (dim_names_tuple, numpy_array, attrs_dict).

    Malformed input fails as a clean ValueError (codec trust boundary)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    try:
        return _read(buf)
    except ValueError:
        raise
    except (IndexError, KeyError, TypeError, AssertionError, OverflowError,
            MemoryError, UnicodeDecodeError, struct.error) as exc:
        raise ValueError(f"corrupt NetCDF-3 file: {exc!r}") from exc


def _read(buf):
    if buf[:3] != b"CDF" or buf[3] not in (1, 2):
        raise ValueError("not a NetCDF classic/64-bit-offset file")
    version = buf[3]
    r = _Reader(buf)
    r.pos = 4
    numrecs = r.u32()
    streaming = numrecs == 0xFFFFFFFF

    tag = r.u32()
    ndims = r.u32()
    assert tag in (NC_DIMENSION, 0)
    dim_names, dim_lens = [], []
    for _ in range(ndims):
        dim_names.append(r.name())
        dim_lens.append(r.u32())
    gattrs = r.attrs()

    tag = r.u32()
    nvars = r.u32()
    assert tag in (NC_VARIABLE, 0)
    headers = []
    for _ in range(nvars):
        nm = r.name()
        nd = r.u32()
        dimids = [r.u32() for _ in range(nd)]
        vattrs = r.attrs()
        t = r.u32()
        vsize = r.u32()
        begin = r.u64() if version == 2 else r.u32()
        headers.append((nm, dimids, vattrs, t, vsize, begin))

    rec_vars = [h for h in headers if h[1] and dim_lens[h[1][0]] == 0]
    # record size: sum of padded per-record sizes; the single-record-var
    # special case has NO padding
    recsize = 0
    for nm, dimids, _, t, vsize, _ in rec_vars:
        per = _SIZES[t] * int(np.prod([dim_lens[d] for d in dimids[1:]], dtype=np.int64))
        recsize += per if len(rec_vars) == 1 else (per + 3) & ~3
    if streaming or numrecs == 0:
        if rec_vars and recsize:
            first = min(h[5] for h in rec_vars)
            numrecs = (len(buf) - first) // recsize
        else:
            numrecs = 0

    variables = {}
    for nm, dimids, vattrs, t, vsize, begin in headers:
        dnames = tuple(dim_names[d] for d in dimids)
        shape = [dim_lens[d] for d in dimids]
        dt = _DTYPES[t]
        if dimids and dim_lens[dimids[0]] == 0:  # record variable
            shape[0] = numrecs
            per_elems = int(np.prod(shape[1:], dtype=np.float64))
            per = _SIZES[t] * per_elems
            stride = recsize
            if per * max(numrecs, 1) > 2 * len(buf) + 4096:
                # uncompressed record data must fit the file: a corrupt
                # dim length cannot be allowed to drive a giant alloc
                raise ValueError(
                    f"corrupt NetCDF-3: record variable needs "
                    f"{per * numrecs} bytes, file has {len(buf)}")
            arr = np.empty(shape, dtype=dt.newbyteorder("="))
            flat = arr.reshape(numrecs, -1)
            for rec in range(numrecs):
                off = begin + rec * stride
                flat[rec] = np.frombuffer(buf, dtype=dt, count=per_elems,
                                          offset=off)
        else:
            nelems = int(np.prod(shape, dtype=np.int64)) if shape else 1
            arr = np.frombuffer(buf, dtype=dt, count=nelems, offset=begin) \
                .reshape(shape).astype(dt.newbyteorder("="), copy=False)
        if t == NC_CHAR:
            arr = arr.view("S1")
        variables[nm] = (dnames, arr, vattrs)

    dims = {n: (numrecs if ln == 0 else ln) for n, ln in zip(dim_names, dim_lens)}
    return dims, variables, gattrs


# ---------------------------------------------------------------- writer
def _pad4(b):
    return b + b"\x00" * (-len(b) % 4)


def _w_name(s):
    b = s.encode("utf-8")
    return struct.pack(">I", len(b)) + _pad4(b)


def _nc_type_of(arr):
    arr = np.asarray(arr)
    if arr.dtype.kind in ("U", "S"):
        return NC_CHAR
    key = (arr.dtype.kind, arr.dtype.itemsize)
    if key == ("i", 8) or key == ("u", 4) or key == ("u", 8):
        raise ValueError(
            f"dtype {arr.dtype} not representable in NetCDF-3; cast to "
            "int32/float64 (CF-encode datetimes first)"
        )
    if key not in _FROM_KIND:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    return _FROM_KIND[key]


def _w_attrs(attrs):
    if not attrs:
        return struct.pack(">II", 0, 0)
    out = [struct.pack(">II", NC_ATTRIBUTE, len(attrs))]
    for k, v in attrs.items():
        if isinstance(v, str):
            t, b, n = NC_CHAR, v.encode("utf-8"), len(v.encode("utf-8"))
        elif isinstance(v, bool):
            a = np.asarray(int(v), dtype=">i4")
            t, b, n = NC_INT, a.tobytes(), 1
        else:
            a = np.atleast_1d(np.asarray(v))
            if a.dtype.kind == "i" and a.dtype.itemsize > 4:
                a = a.astype(">i4")
            if a.dtype.kind == "u":
                a = a.astype(">i4")
            if a.dtype.kind == "b":
                a = a.astype(">i1")
            t = _nc_type_of(a)
            b = a.astype(_DTYPES[t]).tobytes()
            n = a.size
        out.append(_w_name(k) + struct.pack(">II", t, n) + _pad4(b))
    return b"".join(out)


def write(path, dims, variables, attrs=None, record_dim=None, version=2):
    """Write a CDF file.

    dims: {name: length}; variables: {name: (dim_names, array, attrs)};
    record_dim: name of the unlimited dimension (written with length 0).
    version 2 = 64-bit offsets (handles >2 GiB); 1 = classic.
    """
    dim_names = list(dims)
    dim_index = {n: i for i, n in enumerate(dim_names)}
    numrecs = dims[record_dim] if record_dim else 0

    header = [b"CDF", bytes([version]), struct.pack(">I", numrecs)]
    header.append(struct.pack(">II", NC_DIMENSION, len(dim_names))
                  if dim_names else struct.pack(">II", 0, 0))
    for n in dim_names:
        header.append(_w_name(n) +
                      struct.pack(">I", 0 if n == record_dim else dims[n]))
    header.append(_w_attrs(attrs or {}))

    # order: fixed variables first, then record variables (required so the
    # record section is a contiguous tail)
    names = sorted(variables,
                   key=lambda n: bool(variables[n][0] and
                                      variables[n][0][0] == record_dim))
    entries = []
    for nm in names:
        dnames, arr, vattrs = variables[nm]
        arr = np.asarray(arr)
        expect = tuple(dims[d] for d in dnames)
        if tuple(arr.shape) != expect:
            # a short record array would silently interleave empty bytes
            # into the record section, corrupting every later variable
            raise ValueError(f"variable {nm}: shape {arr.shape} does not "
                             f"match dims {dnames} = {expect}")
        t = _nc_type_of(arr)
        is_rec = bool(dnames) and dnames[0] == record_dim
        per_shape = arr.shape[1:] if is_rec else arr.shape
        per = _SIZES[t] * int(np.prod(per_shape, dtype=np.int64))
        vsize = (per + 3) & ~3
        entries.append([nm, dnames, arr, vattrs, t, per, vsize, is_rec])

    rec_entries = [e for e in entries if e[7]]
    single_rec = len(rec_entries) == 1
    recsize = sum(e[5] if single_rec else e[6] for e in rec_entries)

    # assemble variable headers with placeholder offsets, then fix up
    off_fmt = ">Q" if version == 2 else ">I"
    var_hdr = [struct.pack(">II", NC_VARIABLE, len(entries))
               if entries else struct.pack(">II", 0, 0)]
    hdr_parts = []
    for nm, dnames, arr, vattrs, t, per, vsize, is_rec in entries:
        part = (_w_name(nm) + struct.pack(">I", len(dnames))
                + b"".join(struct.pack(">I", dim_index[d]) for d in dnames)
                + _w_attrs(vattrs)
                + struct.pack(">II", t, min(vsize, 2**32 - 1)))
        hdr_parts.append(part)

    base = sum(len(b) for b in header) + len(var_hdr[0]) \
        + sum(len(p) for p in hdr_parts) \
        + len(entries) * (8 if version == 2 else 4)
    offsets = []
    pos = base
    for e in entries:
        if not e[7]:
            offsets.append(pos)
            pos += e[6]
    rec_begin = pos
    for e in entries:
        if e[7]:
            offsets.append(pos)
            pos += e[5] if single_rec else e[6]

    with open(path, "wb") as f:
        for b in header:
            f.write(b)
        f.write(var_hdr[0])
        # offsets are ordered fixed-then-record, matching `entries` order
        n_fixed = sum(1 for e in entries if not e[7])
        fixed_offs, rec_offs = offsets[:n_fixed], offsets[n_fixed:]
        fi, ri = 0, 0
        for part, e in zip(hdr_parts, entries):
            f.write(part)
            if e[7]:
                f.write(struct.pack(off_fmt, rec_offs[ri])); ri += 1
            else:
                f.write(struct.pack(off_fmt, fixed_offs[fi])); fi += 1
        # fixed data
        for nm, dnames, arr, vattrs, t, per, vsize, is_rec in entries:
            if is_rec:
                continue
            b = arr.astype(_DTYPES[t]).tobytes()
            f.write(_pad4(b))
        # record data: interleaved per record.  NB: convert the whole array
        # up front and slice [rec:rec+1] — indexing a 1-D array with [rec]
        # yields a numpy *scalar*, and scalars silently drop the big-endian
        # byte order in astype/tobytes
        rec_arrays = [
            (np.ascontiguousarray(e[2], dtype=_DTYPES[e[4]]), e)
            for e in entries if e[7]
        ]
        for rec in range(numrecs):
            for arr_be, e in rec_arrays:
                b = arr_be[rec:rec + 1].tobytes()
                f.write(b if single_rec else _pad4(b))
