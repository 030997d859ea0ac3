"""Minimal first-party UPnP IGD client — SSDP discovery + SOAP control.

Re-implements the role Open.NAT plays in the reference
(Networking.cs:32-69): when a peer loses the host
election and becomes the session host, it asks the LAN's Internet
Gateway Device to forward the session's UDP port to this machine
(`AddPortMapping`), and removes the mapping again on shutdown
(`DeletePortMapping`, Networking.cs:550).  Everything is plain stdlib
(UDP multicast + HTTP/SOAP over urllib) — no binding packages.

Protocol shape (UPnP Device Architecture 1.0 + WANIPConnection:1):

  1. SSDP: multicast an ``M-SEARCH`` HTTP-over-UDP datagram to
     239.255.255.250:1900 searching for an InternetGatewayDevice; any
     IGD unicasts back a response whose ``LOCATION`` header points at
     its device-description XML.
  2. Description: fetch that XML, walk the nested ``<device>`` tree for
     a ``WANIPConnection`` (or ``WANPPPConnection``) service, and
     resolve its ``<controlURL>`` against the description URL.
  3. Control: POST SOAP envelopes (``AddPortMapping``,
     ``DeletePortMapping``, ``GetExternalIPAddress``) to the control
     URL with the matching ``SOAPACTION`` header.

The SSDP endpoint and timeouts are injectable so tests run against a
loopback fake IGD (tests/test_networking.py) — no real gateway needed.
"""

from __future__ import annotations

import socket
from typing import Dict, Optional, Tuple
from urllib import request as _urlrequest
from urllib.error import HTTPError, URLError
from urllib.parse import urljoin, urlparse
from xml.etree import ElementTree

from softwarerenderer_tpu_torch.utils import slog

log = slog.get_logger("upnp").debug

SSDP_ADDR: Tuple[str, int] = ("239.255.255.250", 1900)
SEARCH_TARGET = "urn:schemas-upnp-org:device:InternetGatewayDevice:1"
# Service types that expose the port-mapping actions, in preference
# order (same set Open.NAT scans for).
_WAN_SERVICES = (
    "urn:schemas-upnp-org:service:WANIPConnection:2",
    "urn:schemas-upnp-org:service:WANIPConnection:1",
    "urn:schemas-upnp-org:service:WANPPPConnection:1",
)


def _local_name(tag: str) -> str:
    """Strip the XML namespace from an element tag."""
    return tag.rsplit("}", 1)[-1]


def _child_text(elem, name: str) -> Optional[str]:
    for ch in elem:
        if _local_name(ch.tag) == name:
            return (ch.text or "").strip()
    return None


def _parse_ssdp_response(data: bytes) -> Optional[str]:
    """Return the LOCATION header of an SSDP 200 response, else None."""
    try:
        text = data.decode("utf-8", "replace")
    except Exception:
        return None
    lines = text.split("\r\n")
    if not lines or "200" not in lines[0]:
        return None
    for line in lines[1:]:
        key, sep, value = line.partition(":")
        if sep and key.strip().lower() == "location":
            return value.strip()
    return None


class Gateway:
    """A discovered IGD's WAN-connection control endpoint."""

    def __init__(self, control_url: str, service_type: str,
                 local_ip: str, http_timeout: float = 2.0):
        self.control_url = control_url
        self.service_type = service_type
        self.local_ip = local_ip           # our address as the IGD routes it
        self.http_timeout = http_timeout

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Gateway({self.control_url!r}, {self.service_type!r}, "
                f"local={self.local_ip})")

    # -- SOAP plumbing ----------------------------------------------------

    def _soap(self, action: str, args: Dict[str, str]) -> Tuple[int, str]:
        """POST one SOAP action; return (HTTP status, response body)."""
        body_args = "".join(
            f"<{k}>{v}</{k}>" for k, v in args.items())
        envelope = (
            '<?xml version="1.0"?>'
            '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"'
            ' s:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
            '<s:Body>'
            f'<u:{action} xmlns:u="{self.service_type}">{body_args}</u:{action}>'
            '</s:Body></s:Envelope>')
        req = _urlrequest.Request(
            self.control_url, data=envelope.encode("utf-8"),
            headers={
                "Content-Type": 'text/xml; charset="utf-8"',
                "SOAPACTION": f'"{self.service_type}#{action}"',
            })
        try:
            with _urlrequest.urlopen(req, timeout=self.http_timeout) as resp:
                return resp.status, resp.read().decode("utf-8", "replace")
        except HTTPError as e:                    # SOAP faults arrive as 500
            return e.code, e.read().decode("utf-8", "replace")
        except (URLError, OSError) as e:
            log(f"SOAP {action} transport error: {e}")
            return 0, ""

    # -- port-mapping actions (Networking.cs:32-52 / Open.NAT
    #    CreatePortMapAsync; :550 DeletePortMapAsync) ----------------------

    def add_port_mapping(self, external_port: int, internal_port: int,
                         protocol: str = "UDP",
                         description: str = "softwarerenderer_tpu",
                         lease_seconds: int = 0,
                         internal_ip: Optional[str] = None) -> bool:
        status, body = self._soap("AddPortMapping", {
            "NewRemoteHost": "",
            "NewExternalPort": str(external_port),
            "NewProtocol": protocol,
            "NewInternalPort": str(internal_port),
            "NewInternalClient": internal_ip or self.local_ip,
            "NewEnabled": "1",
            "NewPortMappingDescription": description,
            "NewLeaseDuration": str(lease_seconds),
        })
        ok = status == 200
        log(f"AddPortMapping {protocol} {external_port} -> "
            f"{internal_ip or self.local_ip}:{internal_port}: "
            f"{'ok' if ok else f'failed (HTTP {status})'}")
        return ok

    def delete_port_mapping(self, external_port: int,
                            protocol: str = "UDP") -> bool:
        status, _ = self._soap("DeletePortMapping", {
            "NewRemoteHost": "",
            "NewExternalPort": str(external_port),
            "NewProtocol": protocol,
        })
        ok = status == 200
        log(f"DeletePortMapping {protocol} {external_port}: "
            f"{'ok' if ok else f'failed (HTTP {status})'}")
        return ok

    def get_external_ip(self) -> Optional[str]:
        status, body = self._soap("GetExternalIPAddress", {})
        if status != 200:
            return None
        try:
            root = ElementTree.fromstring(body)
        except ElementTree.ParseError:
            return None
        for elem in root.iter():
            if _local_name(elem.tag) == "NewExternalIPAddress":
                return (elem.text or "").strip() or None
        return None


def _find_wan_service(xml_text: str, base_url: str
                      ) -> Optional[Tuple[str, str]]:
    """Walk a device-description XML for the first WAN-connection
    service; return (control_url, service_type) or None."""
    try:
        root = ElementTree.fromstring(xml_text)
    except ElementTree.ParseError as e:
        log(f"bad device description: {e}")
        return None
    # URLBase (UPnP 1.0) overrides the description URL as the base.
    base = base_url
    for elem in root.iter():
        if _local_name(elem.tag) == "URLBase" and (elem.text or "").strip():
            base = elem.text.strip()
            break
    found: Dict[str, str] = {}
    for elem in root.iter():
        if _local_name(elem.tag) != "service":
            continue
        stype = _child_text(elem, "serviceType") or ""
        curl = _child_text(elem, "controlURL") or ""
        if stype in _WAN_SERVICES and curl:
            found.setdefault(stype, urljoin(base, curl))
    for stype in _WAN_SERVICES:
        if stype in found:
            return found[stype], stype
    return None


def _local_ip_towards(host: str, port: int) -> str:
    """Our source address for datagrams routed to (host, port)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        try:
            s.connect((host, port or 1))
            return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"


def discover(timeout: float = 1.0,
             ssdp_addr: Tuple[str, int] = SSDP_ADDR,
             search_target: str = SEARCH_TARGET,
             http_timeout: float = 2.0) -> Optional[Gateway]:
    """SSDP M-SEARCH for an IGD; returns the first usable Gateway.

    `ssdp_addr` is injectable so tests can point discovery at a
    loopback fake instead of the real multicast group."""
    msearch = (
        "M-SEARCH * HTTP/1.1\r\n"
        f"HOST: {ssdp_addr[0]}:{ssdp_addr[1]}\r\n"
        'MAN: "ssdp:discover"\r\n'
        f"MX: {max(1, int(timeout))}\r\n"
        f"ST: {search_target}\r\n"
        "\r\n").encode("ascii")
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 2)
        sock.settimeout(timeout)
        try:
            sock.sendto(msearch, ssdp_addr)
        except OSError as e:
            log(f"SSDP send failed: {e}")
            return None
        import time as _time
        deadline = _time.monotonic() + timeout
        while True:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                break
            sock.settimeout(remaining)
            try:
                data, peer = sock.recvfrom(65536)
            except socket.timeout:
                break
            except OSError:
                break
            location = _parse_ssdp_response(data)
            if not location:
                continue
            log(f"SSDP response from {peer}: {location}")
            gw = _gateway_from_location(location, http_timeout)
            if gw is not None:
                return gw
    finally:
        sock.close()
    log("SSDP discovery: no IGD found")
    return None


def _gateway_from_location(location: str,
                           http_timeout: float) -> Optional[Gateway]:
    """Fetch a device description URL and extract its WAN service."""
    try:
        with _urlrequest.urlopen(location, timeout=http_timeout) as resp:
            xml_text = resp.read().decode("utf-8", "replace")
    except (URLError, OSError, ValueError) as e:
        log(f"description fetch failed ({location}): {e}")
        return None
    svc = _find_wan_service(xml_text, location)
    if svc is None:
        log(f"no WAN-connection service in {location}")
        return None
    control_url, service_type = svc
    loc = urlparse(location)
    local_ip = _local_ip_towards(loc.hostname or "127.0.0.1",
                                 loc.port or 80)
    return Gateway(control_url, service_type, local_ip,
                   http_timeout=http_timeout)
