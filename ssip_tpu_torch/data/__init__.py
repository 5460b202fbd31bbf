"""Host-side data layer: decode, decode-once store, device feed."""
