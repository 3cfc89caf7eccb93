"""Training of the SegNet students on pseudo-labels (stage 2)."""
