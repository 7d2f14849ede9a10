"""Network substrate: calibrated link models (``links``) and simulated
transport (``transport``).  Nothing is imported eagerly: import the
module you need."""
