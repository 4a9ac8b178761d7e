"""Small networking helpers for the control plane (the port's copy of
``raydp_tpu/utils/net.py``)."""
from __future__ import annotations

import fcntl
import socket
import struct

_SIOCGIFADDR = 0x8915


def find_free_port(host: str = "127.0.0.1") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def local_ip() -> str:
    """Best-effort non-loopback IPv4 address of this host (falls back to
    127.0.0.1). Reads the interfaces' addresses from the kernel
    (``SIOCGIFADDR``): no packet is sent and no name is resolved, where
    the reference selects a route towards a public address."""
    try:
        interfaces = socket.if_nameindex()
    except OSError:
        return "127.0.0.1"
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for _, name in interfaces:
            if name == "lo":
                continue
            try:
                packed = fcntl.ioctl(s.fileno(), _SIOCGIFADDR,
                                     struct.pack("256s", name[:15].encode()))
            except OSError:
                continue  # no IPv4 address on this interface
            ip = socket.inet_ntoa(packed[20:24])
            if not ip.startswith("127."):
                return ip
    return "127.0.0.1"
