"""index_upload_share: the program's own `index.upload` spans (the two
copies of every arena's codes to the card, any wait on the stream
included, utils/trace.py) over the window, in %. With index_fill_share it
makes up index_prep_share."""

import program_record


def read(t: dict):
    return program_record.share(t, 'index.upload')
