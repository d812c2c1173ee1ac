"""Host-side data: sequencing, labels, zip decoding, frame datasets."""
