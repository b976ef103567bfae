"""The share (%) of a serve cell's traced span in which the device idled
while the host was inside the program's ``serve.prefill`` spans: the
reading of ``device.idle_in_decode_share.serve`` for those spans."""
import functools

from bench import harness

read = functools.partial(harness.reader("device.idle_in_decode_share.serve"),
                         span="serve.prefill")
