from .cli import ts2d_entry_point

if __name__ == '__main__':
    ts2d_entry_point()
