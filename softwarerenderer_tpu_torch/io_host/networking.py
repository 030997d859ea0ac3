"""UDP transport + colon-delimited string RPC + session management.

First-party re-implementation of the reference's hand-rolled networking
(Networking.cs) with identical wire format and semantics,
so peers of the new framework speak the same protocol shape:

  * host election: send "ping" to the target; "pong" within the timeout →
    join as client, else bind the port and become host
    (Networking.cs:71-184)
  * wire format: "RPC:Method:p1:p2:…[:senderId=N]"; transport control
    messages "ping"/"pong"/"id:N" (Networking.cs:250-259, 335-349)
  * host assigns incrementing client ids on a "Ping" RPC with param "0";
    known ids pinging from a new endpoint are re-bound; unknown ids are
    re-assigned (Networking.cs:429-475)
  * BUFFERED RPCs are replayed to late joiners (Networking.cs:265-269,
    439-451)
  * "Disconnect" removes the client and broadcasts "ClientDisconnected"
    (Networking.cs:477-497)
  * at-most-once unreliable delivery over raw UDP — no acks/sequencing,
    faithful to the reference (SURVEY.md §2.2)
  * FAITHFUL QUIRK: the host does NOT relay a client's game RPCs to the
    other clients — only host-originated SendRPC broadcasts (verified
    against Networking.cs:321-427: the receive path invokes the local
    handler only).  Set relay_client_rpcs=True for the fixed topology
    where every client RPC is re-broadcast (sender excluded).

The reference's UPnP port mapping (Open.NAT, Networking.cs:32-69) is a
first-party stdlib client (io_host/upnp.py — SSDP discovery + SOAP
AddPortMapping/DeletePortMapping), opt-in via `upnp_enabled` since
datacenter/LAN deployments have no NAT to traverse; close() unmaps.

Beyond the reference (SURVEY.md §5 "a vanished host strands clients"):
peer_timeout enables traffic-independent failure detection (transport
"hb" keepalives every peer_timeout/3) and, with
enable_host_migration=True, HOST MIGRATION — the host broadcasts the
session roster ("__PeerList"); when clients detect host loss the
lowest-id survivor rebinds the session port as the new host and the
rest rejoin it (client_only handshakes, so a slow election can never
split the session); apps re-announce state from the on_migrated(is_host)
callback.

Receive runs on a daemon thread (the analog of the reference's Task.Run
loop, :321-375); RPCs are BOTH queued for synchronous polling
(poll_rpcs(), recommended — the reference mutates game state from the
network thread and races, SURVEY.md §5) and delivered to on_receive_rpc
callbacks on the receive thread (faithful behavior).
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_PORT = 7777


def _split_batch(body: str) -> List[str]:
    """Split a "BAT:" container body — "<len>:<msg>" repeated, lengths in
    characters of the decoded message — back into messages."""
    out: List[str] = []
    i = 0
    while i < len(body):
        j = body.index(":", i)
        n = int(body[i:j])
        if n < 0 or j + 1 + n > len(body):
            raise ValueError("batch length out of range")
        out.append(body[j + 1:j + 1 + n])
        i = j + 1 + n
    return out


class Networking:
    def __init__(self):
        self._sock: Optional[socket.socket] = None
        self._remote: Optional[Tuple[str, int]] = None
        self.is_host = False
        self.client_id = 0
        self._next_client_id = 1
        self._clients: Dict[Tuple[str, int], int] = {}
        self._buffered_rpcs: List[str] = []
        self._lock = threading.RLock()
        self._recv_thread: Optional[threading.Thread] = None
        self._running = False
        self._id_assigned = threading.Event()
        self._rpc_queue: "queue.Queue[Tuple[str, List[str], int]]" = \
            queue.Queue()
        self.on_receive_rpc: List[Callable[[str, List[str]], None]] = []
        self.relay_client_rpcs = False
        # With relay enabled, method names in this set also join the
        # buffered-RPC replay for late joiners (a playerless dedicated
        # host must buffer CLIENT joins — the reference only ever
        # buffers host-originated sends, Networking.cs:265-269).
        # Entries are pruned when their sender disconnects.
        self.buffer_relayed_methods: set = set()
        self.listening_port = DEFAULT_PORT
        from softwarerenderer_tpu_torch.utils import slog
        self.log: Callable[[str], None] = slog.get_logger("net").debug
        # --- failure detection (absent in the reference — SURVEY.md §5:
        # "a vanished host strands clients").  peer_timeout > 0 enables
        # last-heard tracking: hosts expire silent clients (and broadcast
        # ClientDisconnected), clients flag a silent host via host_lost.
        self.peer_timeout: float = 0.0
        self.host_lost = False
        self.on_host_lost: List[Callable[[], None]] = []
        self._last_heard: Dict[Tuple[str, int], float] = {}
        self._last_host_heard = 0.0
        # --- fault injection for tests (SURVEY.md §5: "no fault injection
        # anywhere" — we add it): fraction of outbound datagrams dropped.
        self.drop_rate: float = 0.0
        self._drop_seq = 0
        # --- reliable delivery (beyond the reference's at-most-once UDP):
        # send_rpc(..., reliable=True) tags the message with a seq number,
        # resends until every addressed peer acks, and receivers dedup by
        # (endpoint, seq) — at-least-once on the wire, exactly-once
        # delivered.  Both ends must run this framework (a reference-shape
        # peer would read the seq tag as an RPC param).
        self.resend_interval: float = 0.25
        self.max_resend_attempts: int = 40
        self._send_seq = 0
        self._pending: Dict[int, dict] = {}         # seq → delivery state
        self._seen_seqs: Dict[Tuple[str, int], set] = {}
        # Delivery-failure surface: called as cb(seq, targets) from the
        # receive thread when a reliable message exhausts its resends with
        # peers still unacked ("exactly-once" otherwise degraded to
        # "maybe-never" with only a debug log).
        self.on_delivery_failed: List[
            Callable[[int, set], None]] = []
        # Coalesced acks: receipts queue per peer and flush as ONE
        # "ack:s1,s2,…" datagram once per flush interval (or when the
        # socket goes idle) instead of one datagram per reliable receipt.
        self.ack_flush_interval: float = 0.05
        self._ack_queue: Dict[Optional[Tuple[str, int]], set] = {}
        self._last_ack_flush = 0.0
        # --- windowed RPC batching (beyond the reference, which sends one
        # datagram per SendRPC — Networking.cs:242-319): with
        # rpc_batch_window > 0 seconds, RPCs initiated within the window
        # coalesce into ONE "BAT:<len>:<msg>…" datagram per destination,
        # so a frame's Update + chat + shoot ride one datagram per peer.
        # Flushed from poll_rpcs() (call it once per frame), the receive
        # loop, close(), or immediately when a batch nears the MTU.
        # Reliable RESENDS stay unbatched (the pending table keeps
        # standalone payloads); host relays are also per-message.
        self.rpc_batch_window: float = 0.0
        self.batch_max_chars: int = 1200     # stay under a typical MTU
        self._batch_queue: Dict[Optional[Tuple[str, int]], List[str]] = {}
        self._batch_started = 0.0
        # Observability: datagrams actually handed to the socket (one per
        # destination; broadcasts count once per client).
        self.datagrams_sent = 0
        # --- host migration (elastic recovery; the reference strands
        # clients when the host vanishes — SURVEY.md §5).  The host
        # broadcasts the session's peer roster ("__PeerList"); with
        # enable_host_migration=True a client that detects host loss
        # (requires peer_timeout > 0) elects the LOWEST-id surviving
        # peer: that peer rebinds the session port as the new host, the
        # rest rejoin it.  on_migrated(is_host) fires when the local
        # peer lands in the new session (apps re-announce state there).
        self.enable_host_migration = False
        self.migration_grace: float = 0.4   # new host's bind head start
        self.migration_attempts: int = 12   # total rejoin attempts, split
                                            # across the candidate list
        self.known_peers: Dict[int, Tuple[str, int]] = {}
        self.on_migrated: List[Callable[[bool], None]] = []
        # Fired when every candidate was exhausted; the object is then
        # disconnected (is_connected False) and the app decides what to
        # do — a silent log line must not be the only failure surface.
        self.on_migration_failed: List[Callable[[], None]] = []
        self.migration_failed = False
        self._migrating = False
        # Transport keepalive: with peer_timeout > 0 both sides emit "hb"
        # datagrams every peer_timeout/3, so failure detection (and
        # migration) is traffic-independent — an idle-but-alive session
        # never reads as a dead one.  A peer with peer_timeout == 0
        # still ANSWERS keepalives it receives with "hba" (reciprocal
        # mode — see the receive loop), so a detector never expires an
        # idle-but-alive app.
        self._last_hb = 0.0
        # --- UPnP port mapping (Networking.cs:32-69): opt-in; when
        # enabled, becoming host maps the session's UDP port on the LAN
        # gateway (io_host/upnp.py) and close() unmaps it
        # (Networking.cs:550).  upnp_ssdp_addr overrides the SSDP
        # multicast endpoint so tests discover a loopback fake IGD.
        self.upnp_enabled = False
        self.upnp_timeout: float = 1.0
        self.upnp_ssdp_addr: Optional[Tuple[str, int]] = None
        self._upnp_gateway = None
        self._upnp_mapped_port: Optional[int] = None

    # -- connection lifecycle ------------------------------------------------

    @property
    def is_connected(self) -> bool:
        return self._sock is not None

    def try_enable_upnp(self, port: int) -> bool:
        """UPnP port mapping (Networking.cs:32-52): when this peer wins
        the host election, ask the LAN gateway to forward the session's
        UDP port here.  Off by default (datacenter/LAN deployments have
        no NAT to traverse); set `upnp_enabled = True` (dust2 `--upnp`)
        before connect() to opt in.  Failures are logged and non-fatal,
        matching the reference's try/catch-and-continue."""
        if not self.upnp_enabled:
            self.log(f"[UPnP] skipped (disabled), port {port}")
            return False
        from softwarerenderer_tpu_torch.io_host import upnp
        gw = upnp.discover(timeout=self.upnp_timeout,
                           ssdp_addr=self.upnp_ssdp_addr or upnp.SSDP_ADDR)
        if gw is None:
            self.log("[UPnP] no gateway found")
            return False
        if not gw.add_port_mapping(port, port, "UDP",
                                   description="softwarerenderer_tpu"):
            self.log(f"[UPnP] mapping UDP {port} failed")
            return False
        self._upnp_gateway = gw
        self._upnp_mapped_port = port
        self.log(f"[UPnP] mapped UDP {port} -> {gw.local_ip}:{port} "
                 f"(external ip {gw.get_external_ip()})")
        return True

    def connect(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                handshake_timeout: float = 1.0,
                id_timeout: float = 5.0, client_only: bool = False) -> bool:
        """Host election + join (Networking.cs:71-184).

        client_only=True skips the become-host fallback (used by the
        migration rejoin loop, where electing a second host would split
        the session)."""
        self._reset_reliable_state()
        self.host_lost = False
        self.listening_port = port
        try:
            addr = socket.getaddrinfo(host, port, socket.AF_INET,
                                      socket.SOCK_DGRAM)[0][4]
        except OSError as e:
            self.log(f"Failed to resolve host '{host}': {e}")
            return False
        self._remote = addr

        # Ping/pong handshake from a temporary socket.
        got_pong = False
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tmp:
            tmp.settimeout(handshake_timeout)
            try:
                tmp.sendto(b"ping", addr)
                data, _ = tmp.recvfrom(65536)
                got_pong = data == b"pong"
            except OSError:
                pass

        if got_pong:
            self.log("Connected as client.")
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.connect(addr)
            self.is_host = False
            self._last_host_heard = time.monotonic()
            self._start_receive_loop()
            self._id_assigned.clear()
            self.send_rpc("Ping", ["0"])
            if not self._id_assigned.wait(id_timeout):
                self.log("Timed out waiting for client id.")
                self.close(send_disconnect=False)
                return False
            return True

        if client_only:
            self.log("No response and client_only set - not electing.")
            return False
        self.log("No response - becoming host...")
        self.try_enable_upnp(port)
        return self._become_host(port)

    def host(self, port: int = DEFAULT_PORT) -> bool:
        """Bind and host directly, skipping the ping/pong election.

        For deployments that KNOW they must host (the dedicated relay
        server, apps.dust2.serve): connect()'s election spends a full
        handshake_timeout unbound and silent, a dead window in which an
        early client's ping goes unanswered and that client elects
        ITSELF host on the same port.  Fails (returns False) when the
        port is already bound — no double-bind."""
        self._reset_reliable_state()
        self.host_lost = False
        self._remote = ("127.0.0.1", port)
        self.try_enable_upnp(port)       # same opt-in as the election path
        return self._become_host(port)

    def _become_host(self, port: int) -> bool:
        """Bind the session port and start hosting (shared by host(),
        the election fallback in connect(), and host migration).

        Deliberately NO SO_REUSEADDR: on UDP it would let two sockets
        share the session port (a second "host" silently splitting the
        traffic); an occupied port must fail loudly instead.  UDP has no
        TIME_WAIT, so migration's immediate rebind doesn't need it."""
        try:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.bind(("0.0.0.0", port))
        except OSError as e:
            self.log(f"Error binding to port {port}: {e}")
            self.close(send_disconnect=False)
            return False
        self.listening_port = port
        self.is_host = True
        self.client_id = 0
        self.host_lost = False
        self.log(f"Listening for connections on port {port}")
        self._start_receive_loop()
        return True

    def close(self, send_disconnect: bool = True) -> None:
        """Networking.Close (:546-573): clients notify the host first."""
        try:
            if self._sock is not None and not self.is_host \
                    and self.client_id != 0 and send_disconnect:
                self.send_rpc("Disconnect", [str(self.client_id)])
        except OSError:
            pass
        self._flush_rpc_batches()        # forced: drain queued RPCs
        self._flush_acks()
        if self._upnp_gateway is not None \
                and self._upnp_mapped_port is not None:
            try:                          # Networking.cs:550 unmap-on-close
                self._upnp_gateway.delete_port_mapping(
                    self._upnp_mapped_port, "UDP")
            except Exception as e:        # non-fatal, like the reference
                self.log(f"[UPnP] unmap failed: {e}")
            self._upnp_gateway = None
            self._upnp_mapped_port = None
        self._running = False
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._recv_thread is not None:
            self._recv_thread.join(timeout=1.0)
            self._recv_thread = None
        self._reset_reliable_state()

    def _reset_reliable_state(self) -> None:
        """Drop reliable-delivery state (seq counter, pending resends,
        seen-seq dedup sets, queued acks) — run on close() AND at the
        start of connect().  Without this, a restarted peer reusing low
        seq numbers would match stale _seen_seqs entries and its new
        reliable RPCs (join/hit/chat) would be silently dropped as
        duplicates."""
        with self._lock:
            self._send_seq = 0
            self._pending.clear()
            self._seen_seqs.clear()
            self._ack_queue.clear()
            self._batch_queue.clear()

    # -- sending -------------------------------------------------------------

    def _send_raw(self, data: bytes, target: Optional[Tuple[str, int]] = None
                  ) -> None:
        sock = self._sock
        if sock is None:
            return
        if self.drop_rate > 0:
            # Deterministic fault injection: drop every k-th datagram to
            # approximate the configured rate (reproducible in tests).
            self._drop_seq += 1
            if (self._drop_seq * self.drop_rate) % 1.0 < self.drop_rate:
                return
        try:
            if self.is_host:
                if target is not None:
                    self.datagrams_sent += 1
                    sock.sendto(data, target)
                else:
                    with self._lock:
                        targets = list(self._clients.keys())
                    for t in targets:
                        self.datagrams_sent += 1
                        sock.sendto(data, t)
            else:
                self.datagrams_sent += 1
                sock.send(data)
        except OSError as e:
            self.log(f"Error sending: {e}")

    def _queue_or_send(self, msg: str, data: bytes,
                       target: Optional[Tuple[str, int]] = None) -> None:
        """First transmission of an outgoing RPC: immediate when batching
        is off, else queued per destination for the windowed flush."""
        if self.rpc_batch_window <= 0:
            self._send_raw(data, target)
            return
        flush_now = False
        with self._lock:
            if not any(self._batch_queue.values()):
                self._batch_started = time.monotonic()
            self._batch_queue.setdefault(target, []).append(msg)
            if sum(len(m) + 8 for m in self._batch_queue[target]) \
                    >= self.batch_max_chars:
                flush_now = True         # near MTU: don't wait the window
        if flush_now:
            self._flush_rpc_batches()

    def _flush_rpc_batches(self, now: Optional[float] = None) -> None:
        """Send queued RPCs — one "BAT:" container datagram per
        destination (a single queued message goes out bare, keeping the
        unbatched wire format for the common case).  With `now` given,
        only flushes once the batch window has elapsed; without it the
        flush is forced (close, MTU pressure)."""
        with self._lock:
            if not self._batch_queue:
                return
            if now is not None and \
                    now - self._batch_started < self.rpc_batch_window:
                return
            queued = self._batch_queue
            self._batch_queue = {}
        for target, msgs in queued.items():
            msgs = list(msgs)
            while msgs:
                take: List[str] = []
                size = 0
                while msgs and (not take or size + len(msgs[0]) + 8
                                <= self.batch_max_chars):
                    m = msgs.pop(0)
                    take.append(m)
                    size += len(m) + len(str(len(m))) + 1
                if len(take) == 1:
                    self._send_raw(take[0].encode("utf-8"), target)
                else:
                    body = "".join(f"{len(m)}:{m}" for m in take)
                    self._send_raw(("BAT:" + body).encode("utf-8"), target)

    def send_rpc(self, method: str, params: Optional[List[str]] = None,
                 target_client_id: int = 0, buffer_rpc: bool = False,
                 reliable: bool = False) -> None:
        """SendRPC (Networking.cs:242-319): local echo + broadcast/target.

        reliable=True (beyond the reference): the message carries a seq
        tag and is resent every `resend_interval` seconds until every
        addressed peer acks it (receivers dedup, so delivery stays
        exactly-once)."""
        if self._sock is None:
            self.log("Cannot send RPC: not connected.")
            return
        params = [str(p) for p in (params or [])]
        msg = "RPC:" + method
        if params:
            msg += ":" + ":".join(params)
        seq = None
        if reliable:
            with self._lock:
                self._send_seq += 1
                seq = self._send_seq
            msg += f":seq={seq}"
        if not self.is_host and self.client_id != 0:
            msg += f":senderId={self.client_id}"
        data = msg.encode("utf-8")

        if self.is_host:
            if buffer_rpc:
                with self._lock:
                    self._buffered_rpcs.append(msg)
            if target_client_id == 0:
                if seq is not None:
                    with self._lock:
                        targets = set(self._clients.keys())
                    self._track_pending(seq, data, targets)
                self._queue_or_send(msg, data)
                self._deliver(method, params, 0)
            else:
                with self._lock:
                    target = next((ep for ep, cid in self._clients.items()
                                   if cid == target_client_id), None)
                if target is not None:
                    if seq is not None:
                        self._track_pending(seq, data, {target})
                    self._queue_or_send(msg, data, target)
                else:
                    self.log(f"Cannot send RPC: client {target_client_id} "
                             "not found.")
        else:
            if seq is not None and self._remote is not None:
                self._track_pending(seq, data, {self._remote})
            self._queue_or_send(msg, data)
            self._deliver(method, params, self.client_id)

    # -- reliable delivery ----------------------------------------------------

    def _track_pending(self, seq: int, data: bytes,
                       targets: set) -> None:
        if not targets:
            return
        with self._lock:
            self._pending[seq] = {
                "data": data, "targets": set(targets),
                "next_send": time.monotonic() + self.resend_interval,
                "attempts": 0}

    def _pump_resends(self, now: float) -> None:
        """Resend unacked reliable messages; called from the receive loop
        (it wakes at least every 0.25 s)."""
        with self._lock:
            due = [(s, p) for s, p in self._pending.items()
                   if now >= p["next_send"]]
            for seq, p in due:
                p["attempts"] += 1
                p["next_send"] = now + self.resend_interval
                if p["attempts"] > self.max_resend_attempts \
                        or not p["targets"]:
                    del self._pending[seq]
            current = {ep for ep in self._clients} if self.is_host else None
        for seq, p in due:
            if p["attempts"] > self.max_resend_attempts or not p["targets"]:
                if p["targets"]:
                    self.log(f"reliable seq {seq} gave up on {p['targets']}")
                    for cb in list(self.on_delivery_failed):
                        cb(seq, set(p["targets"]))
                continue
            for ep in list(p["targets"]):
                if current is not None and ep not in current:
                    p["targets"].discard(ep)   # client left the session
                    continue
                self._send_raw(p["data"],
                               ep if self.is_host else None)

    def _handle_ack(self, msg: str, sender: Tuple[str, int]) -> None:
        # Coalesced wire format: "ack:s1,s2,…" (a single seq is the
        # degenerate one-element case).
        body = msg[len("ack:"):]
        seqs = [int(s) for s in body.split(",") if s.isdigit()]
        with self._lock:
            for seq in seqs:
                p = self._pending.get(seq)
                if p is None:
                    continue
                p["targets"].discard(sender)
                if not self.is_host:
                    p["targets"].clear()  # only the host is ever addressed
                if not p["targets"]:
                    del self._pending[seq]

    def _note_reliable_receipt(self, seq: int,
                               sender: Tuple[str, int]) -> bool:
        """Queue an ack for a tagged message; True when it is new
        (deliver it), False for a resend duplicate (ack only)."""
        with self._lock:
            self._ack_queue.setdefault(
                sender if self.is_host else None, set()).add(seq)
            seen = self._seen_seqs.setdefault(sender, set())
            if seq in seen:
                return False
            seen.add(seq)
            if len(seen) > 4096:         # bound memory; old seqs are stale
                cutoff = max(seen) - 2048
                self._seen_seqs[sender] = {s for s in seen if s > cutoff}
            return True

    def _flush_acks(self) -> None:
        """Send one coalesced "ack:s1,s2,…" datagram per peer with queued
        receipts.  Acks still ride _send_raw so fault injection exercises
        ack loss too (the resend path must converge when acks drop)."""
        with self._lock:
            if not self._ack_queue:
                return
            queued = self._ack_queue
            self._ack_queue = {}
        for target, seqs in queued.items():
            ordered = sorted(seqs)
            # stay well under the datagram size cap
            for i in range(0, len(ordered), 1000):
                body = ",".join(str(s) for s in ordered[i:i + 1000])
                self._send_raw(f"ack:{body}".encode(), target)

    def clear_buffered_rpcs(self) -> None:
        with self._lock:
            self._buffered_rpcs.clear()

    # -- receiving -----------------------------------------------------------

    def _start_receive_loop(self) -> None:
        self._running = True
        self._recv_thread = threading.Thread(target=self._receive_loop,
                                             daemon=True)
        self._recv_thread.start()

    def _receive_loop(self) -> None:
        sock = self._sock
        if sock is None:
            return
        try:
            sock.settimeout(0.25)
        except OSError:
            # close() raced the thread start and already freed the fd
            # (common in fast test teardown) — nothing to receive on.
            return
        while self._running:
            try:
                data, sender = sock.recvfrom(65536)
            except socket.timeout:
                now = time.monotonic()
                self._maybe_heartbeat(now)
                if self.peer_timeout > 0:
                    self._check_timeouts(now)
                self._pump_resends(now)
                self._flush_acks()       # socket idle: drain queued acks
                self._last_ack_flush = now
                self._flush_rpc_batches(now)
                continue
            except OSError:
                if not self._running or self._sock is None:
                    break
                # ICMP port-unreachable surfaces as ECONNREFUSED/RESET on
                # connected UDP sockets: the PEER is gone, not our
                # socket — keep the loop alive so timeout detection (and
                # host migration) can act on the silence.
                time.sleep(0.05)
                now = time.monotonic()
                self._maybe_heartbeat(now)
                if self.peer_timeout > 0:
                    self._check_timeouts(now)
                self._pump_resends(now)
                continue
            msg = data.decode("utf-8", errors="replace").strip()
            now = time.monotonic()
            if self.is_host:
                with self._lock:
                    self._last_heard[sender] = now
            else:
                self._last_host_heard = now
            self._maybe_heartbeat(now)
            if self.peer_timeout > 0:
                self._check_timeouts(now)
            self._pump_resends(now)
            if msg == "hb":
                # Reciprocal keepalive: the sender runs failure detection
                # (it emits hb at peer_timeout/3).  A peer WITHOUT its own
                # detection (peer_timeout == 0) answers with "hba" — sent
                # to the SENDER only and itself never answered — so an
                # idle-but-alive app (e.g. busy loading assets for a
                # minute) is never expired as dead; the reply rate is the
                # detector's own hb cadence, so it always beats the
                # detector's timeout, and the asymmetric message pair
                # (hb→hba, never hba→anything) rules out echo loops.
                if self.peer_timeout <= 0 and now - self._last_hb >= 0.05:
                    self._last_hb = now
                    self._send_raw(
                        b"hba", sender if self.is_host else None)
                continue                 # keepalive: already noted above
            if msg == "hba":
                continue                 # liveness already noted above
            if now - self._last_ack_flush >= self.ack_flush_interval:
                # Under load, acks coalesce across every datagram that
                # arrived within the flush window — one ack datagram per
                # interval instead of one per reliable receipt.
                self._flush_acks()
                self._last_ack_flush = now
            if msg.startswith("ack:"):
                self._handle_ack(msg, sender)
                continue
            if self.is_host and msg == "ping":
                try:
                    sock.sendto(b"pong", sender)
                except OSError:
                    pass
                continue
            if not self.is_host and msg == "pong":
                continue
            if not self.is_host and msg.startswith("id:"):
                self._handle_id_assignment(msg)
                continue
            if msg.startswith("BAT:"):
                # Windowed-batching container: length-prefixed RPC
                # messages, dispatched as if each arrived alone.
                try:
                    subs = _split_batch(msg[4:])
                except (ValueError, IndexError):
                    self.log("malformed batch datagram dropped")
                    subs = []
                for sub in subs:
                    if sub.startswith("RPC:"):
                        self._parse_and_invoke(sub, sender)
                    elif sub.startswith("ack:"):
                        self._handle_ack(sub, sender)
                msg = ""                 # fall through to the ack flush
            if msg.startswith("RPC:"):
                self._parse_and_invoke(msg, sender)
            if time.monotonic() - self._last_ack_flush \
                    >= self.ack_flush_interval:
                self._flush_acks()
                self._last_ack_flush = time.monotonic()
            self._flush_rpc_batches(time.monotonic())

    def _maybe_heartbeat(self, now: float) -> None:
        if self.peer_timeout <= 0:
            return
        if now - self._last_hb >= max(self.peer_timeout / 3.0, 0.05):
            self._last_hb = now
            self._send_raw(b"hb")        # host: broadcast; client: to host

    def _check_timeouts(self, now: float) -> None:
        """Expire silent peers (heartbeat-style failure detection)."""
        if self.is_host:
            with self._lock:
                expired = [(ep, cid) for ep, cid in self._clients.items()
                           if now - self._last_heard.get(ep, now)
                           > self.peer_timeout]
                for ep, cid in expired:
                    del self._clients[ep]
                    self._last_heard.pop(ep, None)
                    # same prune as a graceful Disconnect: drop the
                    # leaver's buffered relayed RPCs (no ghost joins)
                    self._buffered_rpcs = [
                        r for r in self._buffered_rpcs
                        if not r.endswith(f":senderId={cid}")]
            for ep, cid in expired:
                self.log(f"Client {cid} timed out ({ep})")
                self.send_rpc("ClientDisconnected", [str(cid)])
            if expired:
                self._broadcast_peer_list()
        else:
            if not self.host_lost and self._last_host_heard > 0 \
                    and now - self._last_host_heard > self.peer_timeout:
                self.host_lost = True
                self.log("Host timed out")
                for cb in list(self.on_host_lost):
                    cb()
                if self.enable_host_migration:
                    self._start_migration()

    def _handle_id_assignment(self, msg: str) -> None:
        parts = msg.split(":")
        if len(parts) == 2 and parts[1].isdigit():
            self.client_id = int(parts[1])
            self.log(f"Assigned client ID: {self.client_id}")
            self._id_assigned.set()

    def _parse_and_invoke(self, msg: str,
                          sender: Tuple[str, int]) -> None:
        """ParseAndInvokeRPC (Networking.cs:377-427)."""
        parts = msg.split(":")
        if len(parts) < 2 or parts[0] != "RPC":
            self.log(f"Invalid RPC format: {msg}")
            return
        method = parts[1]
        params = parts[2:]

        # Reliable-delivery tag: ack + dedup (beyond the reference; the
        # tag sits before a client's trailing senderId).
        seq = None
        for i in (-1, -2):
            if len(params) >= -i and params[i].startswith("seq="):
                sid = params[i][len("seq="):]
                if sid.isdigit():
                    seq = int(sid)
                    params = params[:i] + (params[i + 1:] if i == -2
                                           else [])
                break
        if seq is not None and not self._note_reliable_receipt(seq, sender):
            return      # resend duplicate: acked again, not re-delivered

        sender_id = 0
        if not self.is_host and params and params[-1].startswith("senderId="):
            sid = params[-1][len("senderId="):]
            if sid.lstrip("-").isdigit():
                sender_id = int(sid)
                params = params[:-1]
        elif self.is_host:
            with self._lock:
                sender_id = self._clients.get(sender, 0)

        if self.is_host:
            if method == "Ping":
                self._handle_host_ping(params, sender)
                return
            if method == "Disconnect":
                self._handle_host_disconnect(params, sender)
                return
            if self.relay_client_rpcs:
                # Optional fixed topology: re-broadcast client RPCs to the
                # other clients (the reference never does this — see module
                # docstring).  The seq tag is stripped: seq namespaces are
                # per-sender, so a relayed tag would collide with the
                # host's own pending table when the other clients ack.
                if seq is not None:
                    msg = msg.replace(f":seq={seq}", "", 1)
                relay = msg if msg.endswith(f"senderId={sender_id}") else \
                    msg + f":senderId={sender_id}"
                data = relay.encode("utf-8")
                with self._lock:
                    others = [ep for ep in self._clients if ep != sender]
                    if method in self.buffer_relayed_methods:
                        self._buffered_rpcs.append(relay)
                for ep in others:
                    self._send_raw(data, ep)
        else:
            if method == "Disconnect":
                return  # client-side log-only (Networking.cs:515-522)

        self._deliver(method, params, sender_id)

    def _deliver(self, method: str, params: List[str],
                 sender_id: int) -> None:
        if method == "__PeerList":
            # transport-internal roster (host migration) — consumed here,
            # never surfaced to the app
            peers: Dict[int, Tuple[str, int]] = {}
            for p in params:
                if "=" in p and "|" in p:
                    cid, ep = p.split("=", 1)
                    ip, prt = ep.split("|", 1)
                    try:
                        peers[int(cid)] = (ip, int(prt))
                    except ValueError:
                        pass
            with self._lock:
                self.known_peers = peers
            return
        self._rpc_queue.put((method, list(params), sender_id))
        for cb in list(self.on_receive_rpc):
            cb(method, list(params))

    def _broadcast_peer_list(self) -> None:
        """Host → clients: the session roster (client id + host-observed
        endpoint) — the shared knowledge host migration elects from."""
        if not self.is_host or self._sock is None:
            return
        with self._lock:
            entries = [f"{cid}={ep[0]}|{ep[1]}"
                       for ep, cid in self._clients.items()]
        self.send_rpc("__PeerList", entries)

    # -- host migration --------------------------------------------------------

    def _start_migration(self) -> None:
        if self._migrating:
            return
        self._migrating = True
        threading.Thread(target=self._migrate, daemon=True).start()

    def _migrate(self) -> None:
        """Elect the lowest-id surviving peer as the new host on the same
        session port; everyone else rejoins it (client_only handshakes,
        so a slow election can never split into two sessions).

        Election safety: a peer may only self-elect from a DELIVERED
        roster (the host's __PeerList always includes its recipient) —
        with no roster this peer cannot know whether a lower id exists,
        so it only ever rejoins.  Candidates are tried lowest-id first;
        if an earlier candidate is unreachable (it died with the host)
        the next one takes over, and `me` self-elects only when every
        LOWER id was exhausted first."""
        with self._lock:
            peers = dict(self.known_peers)
        my_id = self.client_id
        port = self.listening_port
        have_roster = bool(peers)
        old_host = self._remote
        peers.setdefault(my_id, ("127.0.0.1", 0))
        order = sorted(peers)
        self.log(f"host lost: migrating; roster {order}, me {my_id}, "
                 f"roster_delivered={have_roster}")
        self.close(send_disconnect=False)
        ok = is_host = False
        try:
            if not have_roster:
                # No roster ever arrived (lost datagram): never
                # self-elect — only retry the old host endpoint (it may
                # be a reboot) so a split session is impossible.
                candidates = ([("rejoin", old_host[0])]
                              if old_host else [])
            else:
                candidates = [("host", None) if cid == my_id
                              else ("rejoin", peers[cid][0])
                              for cid in order]
            per_candidate = max(1, self.migration_attempts
                                // max(len(candidates), 1))
            for kind, ip in candidates:
                if kind == "host":
                    ok = self._become_host(port)
                    is_host = ok
                    if ok:
                        break
                    continue
                time.sleep(self.migration_grace)
                for _ in range(per_candidate):
                    if self.connect(ip, port, handshake_timeout=0.4,
                                    client_only=True):
                        ok = True
                        break
                    time.sleep(0.25)
                if ok:
                    break
        finally:
            self._migrating = False
        if ok:
            self.migration_failed = False
            for cb in list(self.on_migrated):
                cb(is_host)
        else:
            self.migration_failed = True
            self.log("host migration FAILED (no reachable candidate)")
            for cb in list(self.on_migration_failed):
                cb()

    def poll_rpcs(self, max_items: int = 256
                  ) -> List[Tuple[str, List[str], int]]:
        """Drain queued RPCs on the caller's thread — the race-free way to
        consume network events (the reference mutates Players/ChatMessages
        from the network thread while the render thread iterates them,
        SURVEY.md §5; polling designs that out).  Also flushes any
        batch-window-expired outgoing RPCs (rpc_batch_window), so calling
        this once per frame gives one outgoing datagram per peer per
        frame under batching."""
        self._flush_rpc_batches(time.monotonic())
        out = []
        for _ in range(max_items):
            try:
                out.append(self._rpc_queue.get_nowait())
            except queue.Empty:
                break
        return out

    # -- host session management ----------------------------------------------

    def _handle_host_ping(self, params: List[str],
                          sender: Tuple[str, int]) -> None:
        """HandleHostPingRPC (Networking.cs:429-475)."""
        if not params or not params[0].lstrip("-").isdigit():
            self.log(f"Malformed Ping RPC from {sender}")
            return
        cid = int(params[0])
        sock = self._sock
        if cid == 0:
            with self._lock:
                new_id = self._next_client_id
                self._next_client_id += 1
                self._clients[sender] = new_id
                buffered = list(self._buffered_rpcs)
            self.log(f"New client {sender} assigned ID {new_id}")
            if sock is not None:
                sock.sendto(f"id:{new_id}".encode(), sender)
                for rpc in buffered:
                    sock.sendto(rpc.encode(), sender)
            self._broadcast_peer_list()
            return
        with self._lock:
            existing = next((ep for ep, c in self._clients.items()
                             if c == cid), None)
            if existing is not None and existing != sender:
                del self._clients[existing]
                self._clients[sender] = cid
                self.log(f"Updated client {cid} endpoint to {sender}")
                rebound = True
            else:
                rebound = False
        if rebound:
            # every peer's migration roster must see the NEW endpoint
            self._broadcast_peer_list()
            return
        with self._lock:
            if existing is None:
                new_id = self._next_client_id
                self._next_client_id += 1
                self._clients[sender] = new_id
        if existing is None and sock is not None:
            self.log(f"Client {sender} pinged with unknown ID {cid}; "
                     f"re-assigned {new_id}")
            sock.sendto(f"id:{new_id}".encode(), sender)
        self._broadcast_peer_list()

    def _handle_host_disconnect(self, params: List[str],
                                sender: Tuple[str, int]) -> None:
        """HandleHostDisconnectRPC (Networking.cs:477-497)."""
        if not params or not params[0].lstrip("-").isdigit():
            return
        cid = int(params[0])
        with self._lock:
            entry = next((ep for ep, c in self._clients.items()
                          if c == cid), None)
            if entry is not None:
                del self._clients[entry]
                # drop the leaver's buffered relayed RPCs so late joiners
                # don't resurrect a ghost (buffer_relayed_methods)
                self._buffered_rpcs = [
                    r for r in self._buffered_rpcs
                    if not r.endswith(f":senderId={cid}")]
        if entry is not None:
            self.log(f"Client {cid} disconnected from {entry}")
            self.send_rpc("ClientDisconnected", [str(cid)])
            self._broadcast_peer_list()

    @property
    def connected_clients(self) -> Dict[Tuple[str, int], int]:
        with self._lock:
            return dict(self._clients)
