from repro_torch.core.prefixcache.radix import PrefixCache, RadixNode  # noqa: F401
