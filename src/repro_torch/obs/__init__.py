"""Measurement tools of the PyTorch port (``round_profile``,
``serve_profile``, ``commit_profile``) and their device timer
(``timing``)."""
