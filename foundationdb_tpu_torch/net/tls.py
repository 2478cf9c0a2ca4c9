"""TLS for the transport: mutual authentication + peer verification rules.

Reference: FDBLibTLS/ (FDBLibTLSPlugin.cpp, FDBLibTLSPolicy.cpp,
FDBLibTLSSession.cpp, FDBLibTLSVerify.cpp) — every connection between
cluster processes (and from clients) is mutually-authenticated TLS; a
`verify_peers` expression constrains WHOSE certificate is acceptable beyond
chain validity (e.g. "Check.Valid=1,S.CN=fdb-server"). Here the session
layer is the platform TLS stack (the reference links LibreSSL the same
way); the policy/verify layer — config, context construction, and the
verify-peers clause grammar subset — is this module.

Supported verify_peers clauses (FDBLibTLSVerify.cpp grammar subset):
    Check.Valid=0|1     chain validation off/on (default on)
    S.CN=<name>         subject common name must equal <name>
    I.CN=<name>         issuer common name must equal <name>
Multiple clauses separate with commas and must ALL hold.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass


@dataclass
class TLSConfig:
    cert_path: str
    key_path: str
    ca_path: str | None = None
    verify_peers: str = "Check.Valid=1"

    def _wants_validation(self) -> bool:
        return "Check.Valid=0" not in self.verify_peers

    def server_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        if self._wants_validation():
            ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS
            if self.ca_path:
                ctx.load_verify_locations(self.ca_path)
        else:
            ctx.verify_mode = ssl.CERT_NONE
        return ctx

    def client_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        # cluster certs are identity certs, not host certs: hostname
        # checking is replaced by the verify_peers clause match
        ctx.check_hostname = False
        if self._wants_validation():
            ctx.verify_mode = ssl.CERT_REQUIRED
            if self.ca_path:
                ctx.load_verify_locations(self.ca_path)
        else:
            ctx.verify_mode = ssl.CERT_NONE
        return ctx

    def check_peer(self, peercert: dict | None) -> bool:
        """Apply the verify_peers clauses to a (validated) peer cert."""
        for clause in self.verify_peers.split(","):
            clause = clause.strip()
            if not clause or clause in ("Check.Valid=1", "Check.Valid=0"):
                continue
            field, _, want = clause.partition("=")
            if peercert is None:
                return False
            if field == "S.CN":
                got = _cert_cn(peercert.get("subject", ()))
            elif field == "I.CN":
                got = _cert_cn(peercert.get("issuer", ()))
            else:
                return False  # unknown clause: fail closed
            if got != want:
                return False
        return True


def _cert_cn(rdns) -> str | None:
    for rdn in rdns:
        for k, v in rdn:
            if k == "commonName":
                return v
    return None
