"""Generated wire-protocol v2 key registry — do not hand-edit key sets.

``rmt check`` (rule ``protocol-additivity``) regenerates this file when
core/transfer.py starts sending a NEW request/reply key (additive
evolution, the diff is printed), and FAILS when a key listed here stops
appearing in the code: removing or renaming a wire key breaks rolling
upgrades where old peers still send/expect it. In ``--frozen`` mode
(CI / tests/test_static_analysis.py) additions fail too, so the schema
diff lands in the same commit as the protocol change.
"""

# v2 fetch request: client -> server header dict
REQUEST_KEYS = (
    "codecs",
    "defer_above",
    "length",
    "offset",
    "oid",
    "proto",
    "trace",
)

# v2 fetch reply: server -> client header dict
REPLY_KEYS = (
    "codec",
    "crc",
    "deferred",
    "error",
    "size",
    "total",
)

# observability piggyback frames: worker flush frame + agent pong
FRAME_KEYS = (
    "dadd",
    "ddel",
    "dfull",
    "events",
    "logs",
    "profile",
    "samples",
    "seq",
    "series",
    "stat",
    "type",
)
