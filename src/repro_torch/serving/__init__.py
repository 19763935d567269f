"""The port's paged serving plane: endpoints, the page allocator and the
multi-LLM server."""
