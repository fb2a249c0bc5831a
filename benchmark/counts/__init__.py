"""Operation and byte counts from shapes, and the card's published peaks:
the yardstick the per-layer metrics divide by."""
