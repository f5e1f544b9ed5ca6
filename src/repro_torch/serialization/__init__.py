"""Image formats: pack v1 (read) / v2 (read + write), CRCs, atomic commit,
and the msgpack subset the images use."""
