"""The benchmark's own tests (CPU; the `gpu` ones run on the card)."""
