"""ASGI bridge for @serve.ingress (reference: ray
python/ray/serve/_private/http_util.py ASGIAppReplicaWrapper — FastAPI /
Starlette / any ASGI app runs inside the replica; the proxy forwards the
raw request and gets back status/headers/body).

Request wire format (proxy -> replica):
    {"method", "path", "query_string", "headers": [[k, v]...], "body"}
Response wire format (replica -> proxy):
    {"__serve_http__": True, "status", "headers": [[k, v]...], "body"}
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List


async def run_asgi(app, request: Dict[str, Any]) -> Dict[str, Any]:
    """Run one request through an ASGI app, collecting the full response."""
    scope = {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": request.get("method", "GET"),
        "scheme": "http",
        "path": request.get("path", "/"),
        "raw_path": request.get("path", "/").encode(),
        "query_string": request.get("query_string", b"") or b"",
        "root_path": request.get("root_path", ""),
        "headers": [(k.encode() if isinstance(k, str) else k,
                     v.encode() if isinstance(v, str) else v)
                    for k, v in request.get("headers", [])],
        "client": ("127.0.0.1", 0),
        "server": ("serve", 80),
    }
    body = request.get("body", b"") or b""
    if isinstance(body, str):
        body = body.encode()
    received = {"done": False}

    async def receive():
        if received["done"]:
            # no further events ever arrive (the request is fully buffered
            # and disconnect is not modeled) — block forever, never replay
            while True:
                await asyncio.sleep(3600)
        received["done"] = True
        return {"type": "http.request", "body": body, "more_body": False}

    status = {"code": 500}
    headers: List = []
    chunks: List[bytes] = []

    async def send(message):
        if message["type"] == "http.response.start":
            status["code"] = message["status"]
            headers.extend(
                [(k.decode() if isinstance(k, bytes) else k,
                  v.decode() if isinstance(v, bytes) else v)
                 for k, v in message.get("headers", [])])
        elif message["type"] == "http.response.body":
            chunk = message.get("body", b"")
            if chunk:
                chunks.append(chunk)

    await app(scope, receive, send)
    return {"__serve_http__": True, "status": status["code"],
            "headers": headers, "body": b"".join(chunks)}
