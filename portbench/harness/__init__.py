"""The yardstick's general parts: specification lookup, traffic generation,
the closed-loop window, trace reading, the operation count and peaks, and
the comparison that decides `correct`."""
