"""Measurement tools of the PyTorch port (``round_profile``,
``serve_profile``)."""
