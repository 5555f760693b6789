"""Input pipelines of the port (``repro.data``)."""
