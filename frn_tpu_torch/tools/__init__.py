"""Measuring tools of the port that run on the card (``python -m frn_tpu_torch.tools.<name>``)."""
