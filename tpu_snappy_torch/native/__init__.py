"""Host-side native codecs of the port: the C++ golden and system libsnappy."""
