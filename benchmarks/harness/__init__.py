"""The benchmark harness: cells by name, the traced window, the roofline count."""
