"""The benchmark of bemstokes_tpu_torch: swimmer frame loops on one card.
See README.md."""
