"""The port's sans-IO wire core against the JAX package's, byte for byte.

``sharetrade_tpu_torch.fleet.proto`` is a copy of the JAX ``fleet/proto.py``
(the Python rung; the native rung is not ported), so for the same bytes
both must emit the same event sequences, raise ``ProtocolError`` with the
same status and detail strings, and render the same frames. Corpora are
seeded: valid requests and responses, pipelined bursts, malformed heads,
oversized heads and bodies, and valid frames with one head byte flipped.
The short corpus is torn at every byte offset; the fuzz corpus at seeded
random offsets. ``trace_context``, the trace-id format and the status mapping of
``fleet/wire.py`` (``error_to_status`` / ``status_to_error`` against each
package's serving exceptions) are held the same way. Everything here is exact: no tolerance.
"""

from __future__ import annotations

import json
import random

import pytest

from sharetrade_tpu.fleet import proto as jproto
from sharetrade_tpu.fleet import wire as jwire
from sharetrade_tpu.serve import engine as jengine
from sharetrade_tpu_torch.fleet import proto as tproto
from sharetrade_tpu_torch.fleet import wire as twire
from sharetrade_tpu_torch.serve import engine as tengine

SEED = 20261018


def _req_key(r) -> tuple:
    return (r.method, r.target, sorted(r.headers.items()), r.body,
            r.keep_alive)


def _resp_key(r) -> tuple:
    return (r.status, sorted(r.headers.items()), r.body)


def _drive(parser, chunks, key):
    """Event keys before any error, and (status, detail) of the error."""
    events, err = [], None
    for chunk in chunks:
        try:
            events.extend(parser.feed(chunk))
        except Exception as exc:  # noqa: BLE001 — compared across packages
            err = (type(exc).__name__, exc.status, exc.detail)
            break
    return [key(ev) for ev in events], err, parser.pending_bytes()


def _both(chunks, kind: str):
    if kind == "request":
        return (_drive(jproto.PyRequestParser(), chunks, _req_key),
                _drive(tproto.RequestParser(), chunks, _req_key))
    return (_drive(jproto.PyResponseParser(), chunks, _resp_key),
            _drive(tproto.ResponseParser(), chunks, _resp_key))


def _short_corpus() -> list[bytes]:
    submit = json.dumps({"session": "s-1", "obs": [1.0, 2.0, 3.0]}).encode()
    return [
        jproto.py_render_request("GET", "/healthz", "h:1"),
        jproto.py_render_request("POST", "/v1/submit", "h:1", submit,
                                 headers={"X-Deadline-Ms": "250",
                                          "X-Session-Clock": "3"}),
        jproto.py_render_request("POST", "/v1/submit", "h:1",
                                 b"\x00binary body\xff",
                                 headers={"Connection": "close"}),
        jproto.py_render_request("GET", "/metrics", "h:1"),
    ]


def _fuzz_requests(rng: random.Random) -> list[bytes]:
    blobs = []
    methods = ["GET", "POST", "PUT"]
    for _ in range(20):
        parts = []
        for _ in range(rng.randrange(1, 4)):        # a pipelined burst
            body = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(0, 48)))
            headers = {}
            if rng.random() < 0.4:
                headers["X-Trace-Id"] = rng.choice(
                    ["ab12cd34ef56ab78", "1a2f.3c", "not~a~trace"])
            if rng.random() < 0.3:
                headers["X-Deadline-Ms"] = str(rng.randrange(1, 5000))
            if rng.random() < 0.2:
                headers["Connection"] = rng.choice(["close", "Keep-Alive"])
            parts.append(jproto.py_render_request(
                rng.choice(methods), f"/p/{rng.randrange(100)}", "h:1",
                body, headers=headers or None))
        blobs.append(b"".join(parts))
    blobs += [
        b"GET / HTTP/1.0\r\nHost: h\r\n\r\n",
        b"GET / HTTP/1.0\r\nConnection: Keep-Alive\r\n\r\n",
        b"POST /d HTTP/1.1\r\nX-N: 1\r\nX-N: 2\r\nContent-Length: 2\r\n\r\nhi",
        b"POST /d HTTP/1.1\r\nContent-Length:   2  \r\n\r\nhi",
        b"GARBAGE\r\n\r\n",
        b"ONE TWO THREE FOUR\r\n\r\n",
        b"GET /x HTTP/2\r\n\r\n",
        b"GET /x HTTP/1.1\r\nNoColonHere\r\n\r\n",
        b"GET /x HTTP/1.1\r\n  : empty-name\r\n\r\n",
        b"GET /x HTTP/1.1\r\nContent-Length: xyz\r\n\r\n",
        b"GET /x HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
        (f"POST /x HTTP/1.1\r\nContent-Length: "
         f"{jproto.MAX_BODY_BYTES + 1}\r\n\r\n").encode(),
        b"GET /x HTTP/1.1\r\nX: " + b"a" * (jproto.MAX_HEAD_BYTES + 8),
        b"\r\nGET / HTTP/1.1\r\n\r\n",
    ]
    for _ in range(25):
        raw = bytearray(jproto.py_render_request(
            "POST", "/m", "h:1", b"xyz", headers={"X-K": "v"}))
        raw[rng.randrange(0, 40)] = rng.randrange(256)
        blobs.append(bytes(raw))
    return blobs


def _fuzz_responses(rng: random.Random) -> list[bytes]:
    blobs = []
    for _ in range(15):
        blobs.append(b"".join(
            jproto.py_render_response(
                rng.choice([200, 400, 404, 429, 500, 503, 504, 299]),
                bytes(rng.randrange(256) for _ in range(rng.randrange(48))),
                keep_alive=rng.random() < 0.8,
                extra_headers=({"X-Probe": str(rng.randrange(10))}
                               if rng.random() < 0.4 else None))
            for _ in range(rng.randrange(1, 4))))
    blobs += [
        b"HTTP/1.1 200 OK\r\n\r\n",
        b"NOPE 200 OK\r\nContent-Length: 0\r\n\r\n",
        b"HTTP/1.1 2x0 OK\r\nContent-Length: 0\r\n\r\n",
        b"HTTP/1.1\r\nContent-Length: 0\r\n\r\n",
        b"HTTP/1.1 200 OK with spaced reason\r\nContent-Length: 0\r\n\r\n",
        b"HTTP/1.1 200 OK\r\nContent-Length: bad\r\n\r\n",
    ]
    for _ in range(20):
        raw = bytearray(jproto.py_render_response(200, b"body"))
        raw[rng.randrange(0, 30)] = rng.randrange(256)
        blobs.append(bytes(raw))
    return blobs


def _splits(rng: random.Random, blob: bytes, n_cuts: int) -> list[bytes]:
    if len(blob) < 2:
        return [blob]
    cuts = sorted(rng.sample(range(1, len(blob)), min(n_cuts, len(blob) - 1)))
    return [blob[a:b] for a, b in zip([0] + cuts, cuts + [len(blob)])]


def test_short_request_stream_torn_at_every_offset():
    blob = b"".join(_short_corpus())
    whole = _both([blob], "request")
    assert whole[0] == whole[1] and len(whole[0][0]) == 4
    for split in range(1, len(blob)):
        jax_side, port_side = _both([blob[:split], blob[split:]], "request")
        assert port_side == jax_side == whole[0], split


def test_short_response_stream_torn_at_every_offset():
    blob = b"".join([
        jproto.py_render_response(200, b'{"ok": true}'),
        jproto.py_render_response(503, b'{"error": "engine_failed"}',
                                  keep_alive=False),
        jproto.py_render_response(200, b"metrics text",
                                  content_type="text/plain; version=0.0.4",
                                  extra_headers={"X-Probe": "1"}),
    ])
    whole = _both([blob], "response")
    assert whole[0] == whole[1] and len(whole[0][0]) == 3
    for split in range(1, len(blob)):
        jax_side, port_side = _both([blob[:split], blob[split:]], "response")
        assert port_side == jax_side == whole[0], split


def test_one_byte_at_a_time():
    blob = b"".join(_short_corpus())
    chunks = [blob[i:i + 1] for i in range(len(blob))]
    jax_side, port_side = _both(chunks, "request")
    assert port_side == jax_side and len(port_side[0]) == 4


@pytest.mark.parametrize("kind", ["request", "response"])
def test_seeded_fuzz_corpus_events_and_errors_identical(kind):
    rng = random.Random(SEED)
    corpus = _fuzz_requests(rng) if kind == "request" else \
        _fuzz_responses(rng)
    errors = 0
    for i, blob in enumerate(corpus):
        for chunks in ([blob], _splits(rng, blob, 3), _splits(rng, blob, 9)):
            jax_side, port_side = _both(chunks, kind)
            assert port_side == jax_side, (i, chunks)
            errors += jax_side[1] is not None
    # The corpus exercises the error paths, not only the happy one.
    assert errors >= 20


def test_oversized_and_malformed_refusals_name_the_same_status():
    cases = [b"GET /x HTTP/1.1\r\nX: " + b"a" * (tproto.MAX_HEAD_BYTES + 8),
             b"GARBAGE\r\n\r\n",
             (f"POST /x HTTP/1.1\r\nContent-Length: "
              f"{tproto.MAX_BODY_BYTES + 1}\r\n\r\n").encode()]
    for raw in cases:
        with pytest.raises(tproto.ProtocolError) as port_exc:
            tproto.RequestParser().feed(raw)
        with pytest.raises(jproto.ProtocolError) as jax_exc:
            jproto.PyRequestParser().feed(raw)
        assert (port_exc.value.status, port_exc.value.detail) == \
            (jax_exc.value.status, jax_exc.value.detail) != (None, None)
        assert port_exc.value.status == 400
    assert (tproto.MAX_HEAD_BYTES, tproto.MAX_BODY_BYTES) == \
        (jproto.MAX_HEAD_BYTES, jproto.MAX_BODY_BYTES)


def test_renders_identical_bytes():
    rng = random.Random(SEED + 1)
    for _ in range(60):
        body = bytes(rng.randrange(256) for _ in range(rng.randrange(64)))
        headers = ({"X-Deadline-Ms": str(rng.randrange(9999)),
                    "X-Session-Clock": str(rng.randrange(50))}
                   if rng.random() < 0.5 else None)
        method = rng.choice(["GET", "POST"])
        assert tproto.render_request(method, "/v1/submit", "h:9", body,
                                     headers=headers) == \
            jproto.py_render_request(method, "/v1/submit", "h:9", body,
                                     headers=headers)
        status = rng.choice([200, 400, 404, 429, 500, 503, 504, 299])
        ctype = rng.choice(["application/json",
                            "text/plain; version=0.0.4"])
        keep = rng.random() < 0.7
        extra = {"X-Probe": "1"} if rng.random() < 0.3 else None
        assert tproto.render_response(status, body, ctype, keep_alive=keep,
                                      extra_headers=extra) == \
            jproto.py_render_response(status, body, ctype, keep_alive=keep,
                                      extra_headers=extra)


@pytest.mark.parametrize("headers", [
    {}, {"x-trace-id": "DEADbeef00112233", "x-parent-span": "abc.1f"},
    {"x-trace-id": "ab12"}, {"x-trace-id": "zz99"},
    {"x-trace-id": "a" * 65}, {"x-trace-id": "ab12", "x-parent-span": "n~v"},
    {"x-trace-id": "ab12", "x-parent-span": "f" * 65}, {"x-trace-id": ""},
])
def test_trace_context_identical(headers):
    assert tproto.trace_context(headers) == jproto.trace_context(headers)
    assert (tproto.TRACE_HEADER, tproto.PARENT_HEADER) == \
        (jproto.TRACE_HEADER, jproto.PARENT_HEADER)


def _exceptions(mod):
    return [mod.ServeRejected("queue full", reason="queue_full"),
            mod.ServeRejected("shed", reason="shed_oldest"),
            mod.ServeDeadlineExceeded("late"),
            mod.ServeEngineFailed("dead"),
            ValueError("bad obs"),
            KeyError("boom")]


@pytest.mark.parametrize("i", range(6))
def test_status_mapping_identical_and_round_trips(i):
    port_exc, jax_exc = _exceptions(tengine)[i], _exceptions(jengine)[i]
    status, body = twire.error_to_status(port_exc)
    assert (status, body) == jwire.error_to_status(jax_exc)
    back = twire.status_to_error(status, body)
    jax_back = jwire.status_to_error(status, body)
    assert type(back).__name__ == type(jax_back).__name__
    assert str(back) == str(jax_back)
    if status != 500:
        assert type(back) is type(port_exc)
    if isinstance(port_exc, tengine.ServeRejected):
        assert back.reason == port_exc.reason
    assert (twire.SUBMIT_PATH, twire.HEALTH_PATH, twire.METRICS_PATH,
            twire.DEADLINE_HEADER, twire.CLOCK_HEADER) == \
        (jwire.SUBMIT_PATH, jwire.HEALTH_PATH, jwire.METRICS_PATH,
         jwire.DEADLINE_HEADER, jwire.CLOCK_HEADER)


@pytest.mark.parametrize("raw", [
    b'{"session": "s-1", "obs": [1.0]}', b'{"obs": [1], "session": "x y"}',
    b'{"session": 17, "obs": []}', b'{"session": "a\\"b", "obs": []}',
    b"not json", b'{"obs": [1.0]}'])
def test_extract_session_identical(raw):
    def outcome(mod):
        try:
            return mod.extract_session(raw)
        except ValueError as exc:
            return ("ValueError", str(exc))
    assert outcome(twire) == outcome(jwire)


def test_client_refuses_a_span_sink_and_trace_ids_keep_the_jax_format():
    from sharetrade_tpu.obs.trace import new_trace_id as jax_trace_id
    from sharetrade_tpu_torch.obs.trace import new_trace_id
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        twire.FleetClient("127.0.0.1", 1, sink=object())
    twire.FleetClient("127.0.0.1", 1).close()    # no sink: no connection yet
    ours, theirs = new_trace_id(), jax_trace_id()
    assert len(ours) == len(theirs) and int(ours, 16) >= 0
    assert tproto.trace_context({"x-trace-id": ours}) == \
        jproto.trace_context({"x-trace-id": ours})


def test_set_backend_contract_of_an_unbuilt_checkout(caplog):
    try:
        assert tproto.native_available() is False
        assert "not ported" in tproto.native_load_error()
        assert tproto.set_backend("native") == "py"
        assert tproto.proto_backend == "py"
        assert tproto.RequestParser is tproto.PyRequestParser
        assert tproto.set_backend("py") == "py"
        with pytest.raises(ValueError, match="fleet.proto_backend"):
            tproto.set_backend("quic")
    finally:
        tproto.set_backend("py")
