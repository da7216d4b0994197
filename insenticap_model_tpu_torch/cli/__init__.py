"""Entry-point plumbing shared by the captioning and serving commands."""
