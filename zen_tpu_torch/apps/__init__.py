"""The reference's two demo apps on the port: MPM pitch tracking
(``mpm``) and BTrack beat tracking (``btrack``), each fed by an HPR stem."""
