"""The forged-snapshot byzantine actor.

``forge_snapshot_response`` is the strongest forgery a single byzantine
bootstrap peer can mount against verified fast-forward: it rewrites the
committed history inside its own (otherwise honest) snapshot, recomputes
the commit digest SELF-CONSISTENTLY over the doctored window, and
re-signs the state proof under its own participant key.  Every local
check a joiner can run alone therefore passes — responder signature
valid, digest re-folds over the window, event signatures genuine — and
the forgery is caught exactly where the design says it must be: the
attestation quorum, because no honest peer holds the forged digest at
that position (``babble_ff_proof_rejects_total``).

Seeded-chaos note: forging draws NO randomness (the doctoring is a
deterministic permutation), so enabling the actor never shifts any
other fault stream's draws.
"""

from __future__ import annotations

from .. import codec
from ..crypto.keys import KeyPair
from ..net.commands import FastForwardResponse


def forge_snapshot_response(
    resp: FastForwardResponse, key: KeyPair
) -> FastForwardResponse:
    """Doctor a fast-forward response: swap the two OLDEST entries of
    the committed window (a rewrite of settled history, which every
    honest attester's frontier already covers — a tail-only rewrite
    would sit beyond lagging attesters and only surface as divergence
    later), recompute the digest chain over the doctored window,
    re-sign the proof.  Served unmodified when the committed window is
    too short to rewrite yet."""
    from ..consensus.digest import fold
    from ..store.proof import sign_snapshot_proof, snapshot_hash

    meta_b, npz_b = codec.unpackb(resp.snapshot)
    meta = codec.unpackb(meta_b, strict_map_key=False)
    cons = meta.get("consensus")
    if (isinstance(cons, list) and len(cons) == 2
            and isinstance(cons[1], list)):
        start, items = int(cons[0]), cons[1]   # fused/wide window form
    else:
        start, items = 0, cons                 # fork engines: plain list
    dg = meta.get("digest")
    if not items or len(items) < 2 or not dg:
        return resp
    items[0], items[1] = items[1], items[0]
    anchor, anchor_pos = dg.get("anchor"), dg.get("anchor_pos", 0)
    if anchor is None or anchor_pos != start:
        return resp   # window not re-foldable; nothing to keep consistent
    head = fold(anchor, items)
    dg["head"] = head
    dg["recent"] = [[int(dg["len"]), head]] if dg.get("len") else []
    snap = codec.packb([codec.packb(meta), npz_b])
    r, s = sign_snapshot_proof(
        key, snapshot_hash(snap), resp.lcr, resp.position, head,
        resp.epoch,
    )
    return FastForwardResponse(
        from_addr=resp.from_addr, snapshot=snap, lcr=resp.lcr,
        position=resp.position, digest=head, sig_r=r, sig_s=s,
        epoch=resp.epoch,
    )
