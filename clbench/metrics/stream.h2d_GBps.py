"""stream.h2d_GBps: the streamed epochs' host-to-device chunk copies
(``ChunkFeed.load`` on its side stream): their bytes over their device
time in the trace. The chunk copies are the window's longest host-to-device
copies, one a chunk load; each is a whole chunk of pinned rows. A cell that
streams nothing reads nothing."""


def read(rec):
    t = rec.trace
    if t is None or not rec.chunk_loads:
        return None
    copies = sorted((e - s for name, kind, s, e in t.ops
                     if kind == "memcpy" and "HtoD" in name), reverse=True)
    if not copies:
        return None
    chunks = [c for c in copies[:rec.chunk_loads] if c >= copies[0] / 4]
    return len(chunks) * rec.chunk_bytes / (sum(chunks) / 1e9) / 1e9
