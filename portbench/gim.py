"""GIM files for the benchmark: a frozen writer and a reader.

A ``.gim`` is a 776-byte header followed by a 7z archive of the model tree
(``Cbm/project.cbm``, a subsystem ``F1.cbm`` listing the towers, one
``T<i>.cbm`` with a ``BLHA=lat,lng,h,r`` line and a ``T<i>.fam`` of
properties a tower).

* ``write_gim``: the tree of ``pointcloudhookup_tpu_torch/io/synthetic.py``
  ``build_gim_tree`` (:80-130) in a 7z archive with the Copy coder and a
  plain header, the layout of ``io/sevenzip.py::write_7z`` (:742-912) with
  ``store=True``.
* ``read_blha``: every tower file's BLHA values of a ``.gim`` whose
  archive holds one folder (Copy or LZMA2 coder) and a plain or an
  encoded header, the layouts ``write_7z`` emits; it follows the 7z
  format's own description and nothing of the program's reader.
"""

from __future__ import annotations

import io
import lzma
import struct
import zlib

HEADER_SIZE = 776
MAGIC = b"7z\xbc\xaf\x27\x1c"
K_END, K_HEADER, K_MAIN_STREAMS, K_FILES_INFO = 0x00, 0x01, 0x04, 0x05
K_PACK_INFO, K_UNPACK_INFO, K_SUBSTREAMS_INFO, K_SIZE, K_CRC = 0x06, 0x07, 0x08, 0x09, 0x0A
K_FOLDER, K_CODERS_UNPACK_SIZE, K_NUM_UNPACK_STREAM = 0x0B, 0x0C, 0x0D
K_EMPTY_STREAM, K_NAMES, K_ATTRIBUTES, K_ENCODED_HEADER = 0x0E, 0x11, 0x15, 0x17
COPY, LZMA2 = b"\x00", b"\x21"
FAM_PROPS = {"呼高": "24", "杆塔高": "42.0", "Kv值": "220", "转角": "0.0"}


def number(value: int) -> bytes:
    """7z's variable-length number."""
    for n in range(9):
        if n == 8 or value < (1 << (7 + 7 * n)):
            break
    if n == 8:
        return b"\xff" + value.to_bytes(8, "little")
    mask = (0xFF << (8 - n)) & 0xFF
    return bytes([mask | (value >> (8 * n))]) + (value & ((1 << (8 * n)) - 1)).to_bytes(n, "little")


def tower_tree(towers) -> list[tuple[str, bytes]]:
    """(archive name, bytes) of a one-subsystem model tree; each tower a
    dict with id, lat, lng, h, r."""
    files = [("Cbm/project.cbm", "ENTITYNAME=工程\nSUBSYSTEM=F1.cbm\n")]
    lines = ["ENTITYNAME=线路1", f"GROUPS.NUM={len(towers)}"]
    lines += [f"GROUP=T{i}.cbm" for i in range(len(towers))]
    files.append(("Cbm/F1.cbm", "\n".join(lines) + "\n"))
    for i, t in enumerate(towers):
        files.append((f"Cbm/T{i}.cbm", "\n".join([
            f"ENTITYNAME={t['id']}", "GROUPTYPE=TOWER",
            f"BLHA={t['lat']:.6f},{t['lng']:.6f},{t['h']:.3f},{t['r']:.3f}",
            f"BASEFAMILY=T{i}.fam"]) + "\n"))
        props = dict(FAM_PROPS, 杆塔编号=str(t["id"]))
        files.append((f"Cbm/T{i}.fam", "".join(f"_={k}={v}\n" for k, v in props.items())))
    return [(name, text.encode("utf-8")) for name, text in files]


def write_gim(path: str, towers) -> None:
    """A .gim of the towers: a header of zeros, a Copy-coded 7z archive."""
    entries = tower_tree(towers)
    dirs = ["Cbm"]
    payload = b"".join(data for _, data in entries)
    hdr = io.BytesIO()
    for v in (K_HEADER, K_MAIN_STREAMS, K_PACK_INFO, 0, 1, K_SIZE, len(payload), K_END,
              K_UNPACK_INFO, K_FOLDER, 1):
        hdr.write(number(v))
    hdr.write(b"\x00" + number(1) + bytes([len(COPY)]) + COPY)
    for v in (K_CODERS_UNPACK_SIZE, len(payload), K_END, K_SUBSTREAMS_INFO,
              K_NUM_UNPACK_STREAM, len(entries), K_SIZE):
        hdr.write(number(v))
    for _, data in entries[:-1]:
        hdr.write(number(len(data)))
    hdr.write(number(K_CRC) + b"\x01")
    for _, data in entries:
        hdr.write(struct.pack("<I", zlib.crc32(data)))
    hdr.write(number(K_END) + number(K_END))
    names = [n for n, _ in entries] + dirs
    hdr.write(number(K_FILES_INFO) + number(len(names)))
    bits = [False] * len(entries) + [True] * len(dirs)
    empty = _bits(bits)
    hdr.write(number(K_EMPTY_STREAM) + number(len(empty)) + empty)
    blob = b"\x00" + "\x00".join(n.replace("/", "\\") for n in names).encode("utf-16-le") + b"\x00\x00"
    hdr.write(number(K_NAMES) + number(len(blob)) + blob)
    attrs = b"\x01\x00" + b"".join(struct.pack("<I", 0x20) for _ in entries) + b"".join(
        struct.pack("<I", 0x10) for _ in dirs)
    hdr.write(number(K_ATTRIBUTES) + number(len(attrs)) + attrs)
    hdr.write(number(K_END) + number(K_END))
    header = hdr.getvalue()
    start = struct.pack("<QQI", len(payload), len(header), zlib.crc32(header))
    with open(path, "wb") as f:
        f.write(b"\x00" * HEADER_SIZE)
        f.write(MAGIC + bytes([0, 4]) + struct.pack("<I", zlib.crc32(start)) + start)
        f.write(payload)
        f.write(header)


def _bits(flags) -> bytes:
    out = bytearray((len(flags) + 7) // 8)
    for i, f in enumerate(flags):
        if f:
            out[i // 8] |= 0x80 >> (i % 8)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.f = io.BytesIO(data)

    def byte(self) -> int:
        b = self.f.read(1)
        if not b:
            raise ValueError("7z header ends early")
        return b[0]

    def num(self) -> int:
        first, mask, value = self.byte(), 0x80, 0
        for i in range(8):
            if not first & mask:
                return value | ((first & (mask - 1)) << (8 * i))
            value |= self.byte() << (8 * i)
            mask >>= 1
        return value

    def bits(self, n: int) -> list:
        out, b = [], 0
        for i in range(n):
            if i % 8 == 0:
                b = self.byte()
            out.append(bool(b & (0x80 >> (i % 8))))
        return out


def _streams(r: _Reader):
    """(pack_pos, pack sizes, [(codec, props, unpack size)], substream sizes)."""
    pack_pos, packs, folders, subs = 0, [], [], None
    while True:
        kind = r.byte()
        if kind == K_END:
            return pack_pos, packs, folders, subs
        if kind == K_PACK_INFO:
            pack_pos, n = r.num(), r.num()
            while (k := r.byte()) != K_END:
                if k == K_SIZE:
                    packs = [r.num() for _ in range(n)]
                elif k == K_CRC:
                    if not r.byte():
                        r.bits(n)
                    r.f.read(4 * n)
        elif kind == K_UNPACK_INFO:
            r.byte()  # K_FOLDER
            n = r.num()
            r.byte()  # not external
            for _ in range(n):
                if r.num() != 1:
                    raise ValueError("a folder of more than one coder")
                flags = r.byte()
                codec = r.f.read(flags & 0x0F)
                props = r.f.read(r.num()) if flags & 0x20 else b""
                folders.append([codec, props, 0])
            r.byte()  # K_CODERS_UNPACK_SIZE
            for fo in folders:
                fo[2] = r.num()
            while (k := r.byte()) != K_END:
                if k == K_CRC:
                    if not r.byte():
                        r.bits(len(folders))
                    r.f.read(4 * len(folders))
        elif kind == K_SUBSTREAMS_INFO:
            counts = [1] * len(folders)
            while (k := r.byte()) != K_END:
                if k == K_NUM_UNPACK_STREAM:
                    counts = [r.num() for _ in folders]
                elif k == K_SIZE:
                    subs = []
                    for fo, c in zip(folders, counts):
                        sizes = [r.num() for _ in range(c - 1)]
                        subs += sizes + [fo[2] - sum(sizes)]
                elif k == K_CRC:
                    total = sum(counts)
                    if not r.byte():
                        total = sum(r.bits(total))
                    r.f.read(4 * total)
        else:
            raise ValueError(f"unexpected 7z record {kind:#x}")


def _unpack(archive: bytes, base: int, pack_pos: int, packs, folders) -> bytes:
    out, pos = b"", base + pack_pos
    for size, (codec, props, unpack_size) in zip(packs, folders):
        raw = archive[pos: pos + size]
        pos += size
        if codec == COPY:
            out += raw
        elif codec == LZMA2:
            d = lzma.LZMADecompressor(lzma.FORMAT_RAW, filters=[
                dict(id=lzma.FILTER_LZMA2, dict_size=(2 | (props[0] & 1)) << (props[0] // 2 + 11))])
            out += d.decompress(raw, unpack_size)
        else:
            raise ValueError(f"codec {codec.hex()} is not read here")
    return out


def read_entries(path: str) -> dict:
    """{archive name: bytes} of the files of a .gim."""
    with open(path, "rb") as f:
        archive = f.read()[HEADER_SIZE:]
    if archive[:6] != MAGIC:
        raise ValueError(f"{path!r} holds no 7z archive after its header")
    offset, size, _ = struct.unpack_from("<QQI", archive, 12)
    header = archive[32 + offset: 32 + offset + size]
    r = _Reader(header)
    kind = r.byte()
    if kind == K_ENCODED_HEADER:
        header = _unpack(archive, 32, *_streams(r)[:3])
        r = _Reader(header)
        kind = r.byte()
    if kind != K_HEADER:
        raise ValueError("no 7z header")
    pack_pos, packs, folders, subs = 0, [], [], []
    names, empty = [], []
    while (k := r.byte()) != K_END:
        if k == K_MAIN_STREAMS:
            pack_pos, packs, folders, subs = _streams(r)
            subs = subs if subs is not None else [fo[2] for fo in folders]
        elif k == K_FILES_INFO:
            n = r.num()
            empty = [False] * n
            while (p := r.byte()) != K_END:
                size = r.num()
                body = r.f.read(size)
                if p == K_EMPTY_STREAM:
                    empty = _Reader(body).bits(n)
                elif p == K_NAMES:
                    names = body[1:].decode("utf-16-le").split("\x00")[:n]
    payload = _unpack(archive, 32, pack_pos, packs, folders)
    out, pos, sizes = {}, 0, iter(subs)
    for name, is_empty in zip(names, empty):
        if is_empty:
            continue
        size = next(sizes)
        out[name.replace("\\", "/")] = payload[pos: pos + size]
        pos += size
    return out


def read_blha(path: str) -> dict:
    """{tower id: (lat, lng, h, r)} of every tower file of a .gim."""
    out = {}
    for name, data in read_entries(path).items():
        if not name.endswith(".cbm"):
            continue
        text = data.decode("utf-8")
        if "GROUPTYPE=TOWER" not in text:
            continue
        fields = dict(line.split("=", 1) for line in text.splitlines() if "=" in line)
        out[fields["ENTITYNAME"]] = tuple(float(v) for v in fields["BLHA"].split(","))
    return out
