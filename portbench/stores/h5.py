"""The pool written in set-up to an HDF5 file under ``workdir``, chunked in
``h5_chunk_frames`` frames with shuffle + deflate 4, and read back through
the port's own reader (``open_trajectory``).  The writer needs no h5py (the
card's machine has none): a copy of ``chip_smoke.py::write_h5_trajectory``
and its header helper."""
import os

import numpy as np

_H5_UNDEF = 2 ** 64 - 1


def open_frames(traffic, pool, workdir):
    from sitator_tpu_torch.io import open_trajectory
    path = os.path.join(workdir, "frames.h5")
    write_h5_trajectory(path, pool,
                        chunk_frames=int(traffic["h5_chunk_frames"]))
    reader = open_trajectory(path)
    if getattr(reader, "_h5py", None) is not None:
        reader.close()
        raise RuntimeError("the port's HDF5 reader did not serve the file: "
                           "h5py did")
    return reader, reader.close


def _h5_header(messages):
    """A v1 object header of (type, body) messages, each padded to 8
    bytes; the datatype, fill value and filter pipeline flagged constant,
    as h5py writes them."""
    import struct
    body = b""
    for mtype, data in messages:
        data = data + b"\0" * (-len(data) % 8)
        constant = 1 if mtype in (3, 5, 11) else 0
        body += struct.pack("<HHB3x", mtype, len(data), constant) + data
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def write_h5_trajectory(path, frames, chunk_frames=None):
    """An HDF5 file holding ``frames`` (float32, ``(F, A, 3)``) as the
    dataset ``positions`` of its root group: contiguous, or
    (``chunk_frames``) chunked in whole frames, each chunk byte-shuffled
    and deflated at level 4 (h5py's ``gzip`` default) on 8 threads, the
    chunks indexed by one v1 B-tree leaf."""
    import struct
    import zlib
    from concurrent.futures import ThreadPoolExecutor
    frames = np.ascontiguousarray(frames, np.float32)
    shape = frames.shape
    name = b"positions\0"
    heap_data = b"\0" * 8 + name + b"\0" * (-len(name) % 8)
    chunks = []
    if chunk_frames:
        c0 = int(chunk_frames)

        def encode(i):
            part = np.zeros((c0, *shape[1:]), np.float32)
            part[:min(c0, shape[0] - i * c0)] = frames[i * c0:(i + 1) * c0]
            shuffled = part.reshape(-1).view(np.uint8).reshape(-1, 4).T
            return zlib.compress(shuffled.tobytes(), 4)
        with ThreadPoolExecutor(8) as pool:
            chunks = list(pool.map(encode, range(-(-shape[0] // c0))))
    istore_k = max(32, (len(chunks) + 1) // 2)
    # addresses: superblock, root header, root B-tree, local heap, its
    # data, SNOD, the dataset's header, its chunk B-tree, then the data
    root_oh = 104
    group_bt = root_oh + 40
    heap = group_bt + 24 + 32 * 16 + 8
    heap_at = heap + 32
    snod = heap_at + len(heap_data)
    dset_oh = snod + 8 + 8 * 40
    space = struct.pack("<BBBx4x", 1, len(shape), 1) + struct.pack(
        f"<{2 * len(shape)}Q", *shape, *shape)
    dtype = bytes.fromhex("11201f0004000000") + struct.pack(
        "<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
    fill = struct.pack("<BBBBI", 2, 3 if chunks else 2, 2, 1, 0)
    messages = [(1, space), (3, dtype), (5, fill)]
    if chunks:
        # shuffle (client data: the element size), then deflate (level 4)
        pipeline = struct.pack("<BB6x", 1, 2)
        for fid, fname, cd in ((2, b"shuffle\0", 4), (1, b"deflate\0", 4)):
            pipeline += struct.pack("<HHHH", fid, len(fname), 1, 1) + fname
            pipeline += struct.pack("<Ixxxx", cd)
        messages.append((11, pipeline))
    layout_size = 32 if chunks else 24
    head_size = len(_h5_header(messages + [(8, b"\0" * layout_size)]))
    chunk_bt = dset_oh + head_size
    key_size = 8 + 8 * (len(shape) + 1)
    data_at = chunk_bt + (24 + 2 * istore_k * (key_size + 8) + key_size
                          if chunks else 0)
    if chunks:
        layout = struct.pack("<BBBQ", 3, 2, len(shape) + 1, chunk_bt) + \
            struct.pack(f"<{len(shape) + 1}I", c0, *shape[1:], 4)
    else:
        layout = struct.pack("<BBQQ", 3, 1, data_at, frames.nbytes)
    dset = _h5_header(messages + [(8, layout)])
    assert len(dset) == head_size
    eof = data_at + (sum(map(len, chunks)) if chunks else frames.nbytes)
    sb = (b"\x89HDF\r\n\x1a\n" + struct.pack(
        "<BBBBBBBBHHIHH", 1, 0, 0, 0, 0, 8, 8, 0, 4, 16, 0, istore_k, 0)
        + struct.pack("<QQQQ", 0, _H5_UNDEF, eof, _H5_UNDEF)
        + struct.pack("<QQII", 0, root_oh, 1, 0)
        + struct.pack("<QQ", group_bt, heap))
    sb += b"\0" * (root_oh - len(sb))
    root = _h5_header([(17, struct.pack("<QQ", group_bt, heap))])
    tree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _H5_UNDEF, _H5_UNDEF)
            + struct.pack("<QQQ", 0, snod, 8))
    tree += b"\0" * (heap - group_bt - len(tree))
    # free list offset 1: the heap has no free block
    local = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1, heap_at)
    entries = struct.pack("<QQII16x", 8, dset_oh, 0, 0)
    symbols = b"SNOD" + struct.pack("<BxH", 1, 1) + entries
    symbols += b"\0" * (dset_oh - snod - len(symbols))
    with open(path, "wb") as f:
        f.write(sb + root + tree + local + heap_data + symbols + dset)
        if chunks:
            node = b"TREE" + struct.pack("<BBHQQ", 1, 0, len(chunks),
                                         _H5_UNDEF, _H5_UNDEF)
            at = data_at
            for i, blob in enumerate(chunks):
                node += struct.pack(f"<II{len(shape) + 1}Q", len(blob), 0,
                                    i * c0, *[0] * len(shape)) + \
                    struct.pack("<Q", at)
                at += len(blob)
            node += struct.pack(f"<II{len(shape) + 1}Q", 0, 0,
                                len(chunks) * c0, *[0] * len(shape))
            f.write(node + b"\0" * (data_at - chunk_bt - len(node)))
            for blob in chunks:
                f.write(blob)
        else:
            f.write(memoryview(frames.reshape(-1).view(np.uint8)))
