"""Host-side runtime: native IO kernels, codec bindings, stream graph,
scraper, audio pipeline."""
