"""The port's paged serving plane: endpoints, the page allocator and the
multi-LLM server; and the seeded fault plans (``faults``) the simulator
injects."""
