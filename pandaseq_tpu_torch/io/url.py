"""URL input (the libpandaseq-url / curl_reader.c equivalent).

The reference inverts libcurl's push callbacks into a pull stream with
ucontext coroutines (curl_reader.c:86-143); Python's urllib response
objects are already pull-based file objects, so the whole trick reduces
to opening the stream and layering the same magic-byte compression sniff
over it (fileio.c:60-98). file://, http://, https:// and ftp:// are
supported (urllib's default opener includes an FTP handler — the same
scheme set libcurl serves the reference).

The PyTorch port's copy of ``pandaseq_tpu/io/url.py``, unchanged but for its
imports; the port imports nothing of ``pandaseq_tpu``.
"""

from __future__ import annotations

import bz2
import gzip
import io
import urllib.request


class _PeekStream(io.RawIOBase):
    """Wrap a non-seekable response with 3-byte peek for sniffing."""

    def __init__(self, resp):
        self.resp = resp
        self.head = resp.read(3)
        self.pos = 0

    def readable(self):
        return True

    def readinto(self, b):
        n = 0
        if self.pos < len(self.head):
            take = min(len(b), len(self.head) - self.pos)
            b[:take] = self.head[self.pos:self.pos + take]
            self.pos += take
            n += take
            if n == len(b):
                return n
        chunk = self.resp.read(len(b) - n)
        b[n:n + len(chunk)] = chunk
        return n + len(chunk)


def open_url(url: str):
    """panda_open_url (pandaseq-url.h:49): pull-stream over a URL with
    gz/bz2 auto-detection. Plain local paths pass through."""
    if "://" not in url:
        from .fastq import open_buffer
        return open_buffer(url)
    resp = urllib.request.urlopen(url)
    raw = io.BufferedReader(_PeekStream(resp))
    head = raw.peek(3)[:3]
    if head[:2] == b"BZ":
        return bz2.open(raw)
    if head[:2] == b"\x1f\x8b":
        return gzip.open(raw)
    return raw
