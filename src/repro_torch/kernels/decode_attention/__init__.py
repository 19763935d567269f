"""Split-KV paged decode attention (the serving plane's decode hot loop)."""
