"""Rep3 (3-party replicated) shares on one device: a leading party axis."""
