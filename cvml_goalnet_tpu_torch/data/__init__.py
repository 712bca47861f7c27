"""Input data helpers of the port."""
