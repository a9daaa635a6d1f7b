"""A small HTTP/1.1 server on asyncio streams (the server's stand-in for
aiohttp.web, which the card's machine lacks).

  * Requests: the request line and headers (at most MAX_HEAD_BYTES and
    MAX_HEADERS), a body of `Content-Length` bytes or chunked (at most
    MAX_BODY_BYTES; 413 past it), `Expect: 100-continue` answered, and
    keep-alive (HTTP/1.1 unless `Connection: close`; HTTP/1.0 only
    with `Connection: keep-alive`).
  * Responses: `Response` (a whole body with its length; `json_response`
    writes `json.dumps(obj)` as aiohttp's does) and `StreamResponse`
    (chunked transfer, each `write` one chunk, flushed at once: the
    server's SSE streams).
  * `Router`: exact paths; an unknown path answers 404 and a known path
    with another method 405, in aiohttp's plain-text form.
  * A handler's uncaught exception answers 500 (aiohttp's text), or
    closes the connection once a stream has started.

`ServerThread` runs a server on its own event loop in a thread (the
CLI's `serve` waits on it in the foreground).
"""

from __future__ import annotations

import asyncio
import json
import threading
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Dict, Optional
from urllib.parse import unquote

MAX_HEAD_BYTES = 64 * 1024
MAX_HEADERS = 128
MAX_BODY_BYTES = 32 * 1024 * 1024


def _reason(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


class HTTPError(Exception):
    """Answer `status` with a plain-text body (aiohttp's form)."""

    def __init__(self, status: int, text: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(status)
        self.status = status
        self.text = text if text is not None \
            else f"{status}: {_reason(status)}"
        self.headers = headers or {}


class Request:
    def __init__(self, method: str, target: str, version: str,
                 headers: Dict[str, str], body: bytes,
                 writer: asyncio.StreamWriter):
        self.method = method
        path, _, self.query_string = target.partition("?")
        self.path = unquote(path)
        self.version = version
        self.headers = headers           # lower-case names
        self.body = body
        self._writer = writer
        self.stream: Optional["StreamResponse"] = None

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8"))

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return "keep-alive" in conn
        return "close" not in conn


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.headers = {"Content-Type": content_type, **(headers or {})}


def json_response(obj: Any, status: int = 200) -> Response:
    return Response(json.dumps(obj).encode(), status,
                    "application/json; charset=utf-8")


def text_response(text: str, status: int = 200,
                  content_type: str = "text/plain") -> Response:
    return Response(text.encode(), status, f"{content_type}; charset=utf-8")


class StreamResponse:
    """A response written in pieces; HTTP/1.1 chunked, or to the close of
    the connection for an HTTP/1.0 client."""

    def __init__(self, request: Request, status: int = 200,
                 headers: Optional[Dict[str, str]] = None):
        self._req = request
        self._w = request._writer
        self._chunked = request.version != "HTTP/1.0"
        self.status = status
        self.headers = dict(headers or {})
        self.prepared = False
        self.finished = False
        request.stream = self

    async def prepare(self) -> None:
        head = dict(self.headers)
        if self._chunked:
            head["Transfer-Encoding"] = "chunked"
        else:
            head["Connection"] = "close"
        _write_head(self._w, self.status, head)
        self.prepared = True
        await self._w.drain()

    async def write(self, data: bytes) -> None:
        if not data:
            return
        if self._chunked:
            self._w.write(b"%x\r\n%s\r\n" % (len(data), data))
        else:
            self._w.write(data)
        await self._w.drain()

    async def finish(self) -> None:
        if self._chunked and not self.finished:
            self._w.write(b"0\r\n\r\n")
            await self._w.drain()
        self.finished = True


Handler = Callable[[Request], Awaitable[Any]]


class Router:
    def __init__(self):
        self._routes: Dict[str, Dict[str, Handler]] = {}

    def add(self, method: str, path: str, handler: Handler) -> None:
        self._routes.setdefault(path, {})[method] = handler

    def resolve(self, request: Request) -> Handler:
        by_method = self._routes.get(request.path)
        if by_method is None:
            raise HTTPError(404)
        handler = by_method.get(request.method)
        if handler is None:
            raise HTTPError(405, headers={"Allow": ",".join(by_method)})
        return handler


def _write_head(w: asyncio.StreamWriter, status: int,
                headers: Dict[str, str]) -> None:
    lines = [f"HTTP/1.1 {status} {_reason(status)}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    w.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    body = bytearray()
    while True:
        size_line = await reader.readuntil(b"\r\n")
        size = int(size_line.split(b";")[0].strip(), 16)
        if size == 0:
            while (await reader.readuntil(b"\r\n")) != b"\r\n":
                pass                     # trailers
            return bytes(body)
        if len(body) + size > MAX_BODY_BYTES:
            raise HTTPError(413)
        body += await reader.readexactly(size)
        await reader.readexactly(2)


async def _read_request(reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter) -> Optional[Request]:
    """The next request on the connection, None at its clean end."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if e.partial.strip():
            raise HTTPError(400, "400: Bad Request (truncated head)")
        return None
    except asyncio.LimitOverrunError:
        raise HTTPError(431)
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HTTPError(400, "400: Bad Request (request line)")
    method, target, version = parts
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep or not name.strip():
            raise HTTPError(400, "400: Bad Request (header line)")
        key = name.strip().lower()
        value = value.strip()
        headers[key] = f"{headers[key]}, {value}" if key in headers \
            else value
    if len(headers) > MAX_HEADERS:
        raise HTTPError(431)
    if headers.get("expect", "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = await _read_chunked(reader)
    else:
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise HTTPError(400, "400: Bad Request (content-length)")
        if length < 0:
            raise HTTPError(400, "400: Bad Request (content-length)")
        if length > MAX_BODY_BYTES:
            raise HTTPError(413)
        body = await reader.readexactly(length) if length else b""
    return Request(method.upper(), target, version, headers, body, writer)


class HttpServer:
    """Serves `handler(request)` -> Response (or a StreamResponse it
    has written) on every connection."""

    def __init__(self, handler: Handler):
        self.handler = handler
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set = set()

    async def start(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(
            self._connection, host, port, limit=MAX_HEAD_BYTES)
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        """Stop listening and close every open connection."""
        if self._server is not None:
            self._server.close()
            for w in list(self._writers):
                w.close()
            await self._server.wait_closed()

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                try:
                    req = await _read_request(reader, writer)
                except HTTPError as e:
                    self._send(writer, text_response(e.text, e.status),
                               keep_alive=False)
                    await writer.drain()
                    return
                if req is None:
                    return
                keep = await self._serve(req, writer) and req.keep_alive
                await writer.drain()
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _serve(self, req: Request, writer) -> bool:
        """Answer one request; False when the connection must close."""
        try:
            resp = await self.handler(req)
        except HTTPError as e:
            resp = Response(e.text.encode(), e.status, headers=e.headers)
        except (ConnectionError, asyncio.IncompleteReadError):
            return False
        except Exception:                            # noqa: BLE001
            if req.stream is not None and req.stream.prepared:
                return False
            resp = text_response(
                "500 Internal Server Error\n\nServer got itself in "
                "trouble", 500)
        if isinstance(resp, StreamResponse):
            if not resp.prepared:
                await resp.prepare()
            await resp.finish()
            return resp._chunked
        self._send(writer, resp, keep_alive=req.keep_alive)
        return True

    @staticmethod
    def _send(writer, resp: Response, keep_alive: bool) -> None:
        head = dict(resp.headers)
        head["Content-Length"] = str(len(resp.body))
        if not keep_alive:
            head["Connection"] = "close"
        _write_head(writer, resp.status, head)
        writer.write(resp.body)


class ServerThread:
    """An HttpServer on its own event loop in a daemon thread: `port`
    is the bound port (ask for 0 to take a free one); `stop()` closes
    the server and ends the loop."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1",
                 port: int = 0, timeout: float = 30.0):
        self._http = HttpServer(handler)
        self.loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._stopping = False
        self.port = 0
        self._thread = threading.Thread(target=self._run, args=(host, port),
                                        name="ferrum-torch-http",
                                        daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("HTTP server did not start")
        if self._error is not None:
            raise self._error

    def _run(self, host: str, port: int) -> None:
        asyncio.set_event_loop(self.loop)
        try:
            self.port = self.loop.run_until_complete(
                self._http.start(host, port))
        except BaseException as e:                   # noqa: BLE001
            self._error = e
            self._ready.set()
            return
        self._ready.set()
        self.loop.run_forever()
        self.loop.run_until_complete(self._http.close())
        pending = asyncio.all_tasks(self.loop)
        for task in pending:
            task.cancel()
        self.loop.run_until_complete(
            asyncio.gather(*pending, return_exceptions=True))
        self.loop.close()

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def wait(self) -> None:
        """Block until the server's loop ends (stop() or a failure)."""
        while self._thread.is_alive():
            self._thread.join(0.5)

    def stop(self, timeout: float = 30.0) -> None:
        """End the loop (once; also before it has started running)."""
        if not self._stopping and self._thread.is_alive():
            self._stopping = True
            self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout)

