"""DRN backbone: the share of labelled images whose features the folded
DRN (eval BN folded into the convolutions, one epilogue kernel a
convolution) computed, 100 x the program's counters ``drn.folded_images``
over ``drn.images`` while traced.  A program without the counters gives
None."""

from perfbench import spans


def read(run):
    c = spans.traced_counts()
    if not c.get("drn.images") or "drn.folded_images" not in c:
        return None
    return 100.0 * c["drn.folded_images"] / c["drn.images"]
