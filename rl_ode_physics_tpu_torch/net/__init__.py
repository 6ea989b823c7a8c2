"""The game server: wire protocol, transports, SimCore/GameServer, replay, client and CLI."""
