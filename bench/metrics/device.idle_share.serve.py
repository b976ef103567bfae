"""The device's idle share (%) in a serve cell's traced span
(``devicetrace.idle_share``)."""
from bench.devicetrace import idle_share as read  # noqa: F401
