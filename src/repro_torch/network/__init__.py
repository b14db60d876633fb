"""Network models of the paper (§2.3.2, §5.1): pure Python, no device."""
