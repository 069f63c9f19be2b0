"""Native host code of the port: the pitch trackers (``pitch.cpp``)."""
