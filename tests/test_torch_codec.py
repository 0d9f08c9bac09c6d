"""The port's binary codec (kubernetes_tpu_torch/machinery/codec.py) and its
wiring into the client (client/rest.py HTTPTransport(binary=True)) and the
apiserver's HTTP gateway, held against the JAX package's.

tests/test_codec.py's cases, each run on both packages (tests/
test_torch_twin.py `mirror`): the fuzz round trip, key order, the bad magic,
the size, frames under any split, the REST verbs and an informer over the
negotiated binary wire. Every encode, decode, frame and client request the
case makes returns the same bytes and objects on both packages. Beyond
them: one object corpus encoded by both packages gives the same bytes, and
each package decodes the other's frames. All host code: equality is exact.
"""

import random

import pytest
from test_codec import rand_value
from test_torch_twin import mirror

from kubernetes_tpu.machinery import codec as jcodec
from kubernetes_tpu_torch.machinery import codec as tcodec

mirror(globals(), "test_codec", record=[
    "machinery.codec.encode", "machinery.codec.decode",
    "machinery.codec.encode_frame", "machinery.codec.decode_frames",
    "client.rest.HTTPTransport.request"])


@pytest.mark.parametrize("seed", range(4))
def test_same_bytes_as_the_jax_package(seed):
    rng = random.Random(seed)
    for _ in range(100):
        v = rand_value(rng)
        blob = tcodec.encode(v)
        assert blob == jcodec.encode(v)
        assert jcodec.decode(blob) == tcodec.decode(blob) == v
        frame = tcodec.encode_frame({"type": "ADDED", "object": v})
        assert frame == jcodec.encode_frame({"type": "ADDED", "object": v})
        assert jcodec.decode_frames(frame + frame[:3]) == \
            tcodec.decode_frames(frame + frame[:3])


def test_negotiation_helpers_match():
    for accept in ("", "application/json",
                   tcodec.BINARY_MEDIA_TYPE,
                   f"application/json, {tcodec.BINARY_MEDIA_TYPE};q=0.9"):
        assert tcodec.accepts_binary(accept) == jcodec.accepts_binary(accept)
    assert tcodec.BINARY_MEDIA_TYPE == jcodec.BINARY_MEDIA_TYPE
