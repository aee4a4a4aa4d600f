"""Thin-client mode: drive a remote cluster without joining it.

The reference's Ray Client (python/ray/util/client/ — gRPC proxy server
on the head node at util/client/server/, thin client at worker.py:81,
proto src/ray/protobuf/ray_client.proto). Here the wire is an
authenticated multiprocessing.connection TCP channel: the driver hosts a
``ClusterServer`` and remote processes ``connect()`` a backend that
proxies the full task/actor/object API. All values travel serialized —
the client has no shared-memory store, exactly like the reference's
client mode (and with the same bandwidth trade-off its
client__put_gigabytes benchmark measures).
"""

from .client import ClientBackend, connect, disconnect  # noqa: F401
from .server import ClusterServer  # noqa: F401
