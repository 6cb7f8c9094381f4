"""Serving tools of the port: the multi-card deployment (``serve_pod``) and
the long-running serving check (``soak``)."""
